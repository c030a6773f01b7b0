"""The port's process groups on the CPU (npp_tpu_torch/parallel/
{mesh,multihost,launch}.py), as tests/test_multihost.py and
tests/test_parallel.py hold npp_tpu's: the mesh's axis sizes against
npp_tpu's make_mesh on the 8 virtual devices, the shard and gather round
trip without a group and at two, three (an odd pad) and four ranks,
multihost's no-op cases and round-robin, a two-process initialize from
npp_tpu's environment names with one all-reduce, and the dry run.

Ranks are gloo processes started by parallel/launch.py::spawn: a file://
init under tmp_path (never a TCP port, so parallel test workers cannot
collide), a 60-s timeout on the group and a 60-s deadline that kills the
ranks and fails the test, one torch thread each, and every rank checks
that it holds no JAX."""
import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from npp_tpu_torch.parallel import launch, mesh as TM, multihost
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

DEADLINE = 60.0
ENV = ('COORDINATOR_ADDRESS', 'NUM_PROCESSES', 'PROCESS_ID', 'MASTER_ADDR',
       'MASTER_PORT', 'WORLD_SIZE', 'RANK', 'LOCAL_RANK')


def _tree():
    rng = np.random.RandomState(0)
    return {'a': torch.as_tensor(rng.randn(5, 3).astype(np.float32)),
            'b': torch.arange(7, dtype=torch.float64)}


def test_mesh_axis_sizes_match_npp_tpu(tmp_path):
    """make_mesh(('images', 'pixels'), (2, 2)) over four ranks has
    npp_tpu's axis sizes, and rank r sits where npp_tpu puts device r
    (row-major); the default shape puts every rank on the first axis, and
    without a group the mesh has one rank."""
    from npp_tpu.parallel.mesh import make_mesh as jax_mesh
    want = jax_mesh(('images', 'pixels'), (2, 2), jax.devices()[:4])
    outs = launch.spawn(functools.partial(
        launch.mesh_probe, _tree(), ('images', 'pixels'), (2, 2)), 4, 'gloo',
        str(tmp_path / 'init'), timeout=DEADLINE)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    tree = _tree()
    for r, o in enumerate(outs):
        assert o['shape'] == dict(want.shape)
        assert ids[o['coords']] == jax.devices()[r].id
        # 'images' blocks, replicated along 'pixels'; the gather drops the
        # replicas and the padding
        i = o['coords'][0]
        np.testing.assert_array_equal(o['block']['b'],
                                      tree['b'].numpy()[[4 * i, 4 * i + 1,
                                                         4 * i + 2,
                                                         min(4 * i + 3, 6)]])
        for k, x in tree.items():
            np.testing.assert_array_equal(o['gathered'][k], x.numpy())
    assert TM.make_mesh(('images', 'pixels')).shape == {'images': 1,
                                                        'pixels': 1}
    assert dict(jax_mesh(('images', 'pixels'), None,
                         jax.devices()[:1]).shape) == {'images': 1,
                                                       'pixels': 1}
    with pytest.raises(ValueError, match='needs 4 ranks'):
        TM.make_mesh(('images', 'pixels'), (2, 2))


def test_shard_gather_round_trip_without_a_group():
    assert not dist.is_initialized()
    mesh = TM.make_mesh()
    assert mesh.shape == {'images': 1} and mesh.group is None
    tree = _tree()
    block = TM.shard_leading_axis(tree, mesh)
    back = TM.gather_leading_axis(block, mesh, n=5)
    for k in tree:
        assert torch.equal(block[k], tree[k])
    assert torch.equal(back['a'], tree['a'])
    assert TM.group_mesh() is None


@pytest.mark.parametrize('world', [2, 3])
def test_shard_gather_round_trip(world, tmp_path):
    """Rank r holds the contiguous rows [r*b/n, (r+1)*b/n) of the axis
    padded to b by repeating the last row; the gather returns the input
    (5 and 7 rows: padded to 6 and 8 at two ranks, to 6 and 9 at three)."""
    tree = _tree()
    outs = launch.spawn(functools.partial(launch.mesh_probe, tree), world,
                        'gloo', str(tmp_path / 'init'), timeout=DEADLINE)
    for k, x in tree.items():
        x = x.numpy()
        n = x.shape[0]
        b = -(-n // world) * world
        padded = np.concatenate([x, np.repeat(x[-1:], b - n, 0)])
        for r, o in enumerate(outs):
            assert o['coords'] == (r,)
            np.testing.assert_array_equal(
                o['block'][k], padded[r * b // world:(r + 1) * b // world])
            np.testing.assert_array_equal(o['gathered'][k], x)


def test_initialize_noop_single_process(monkeypatch):
    """tests/test_multihost.py:18-26's cases: no coordinator or one process
    joins no group and never raises."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    multihost.initialize()
    multihost.initialize(num_processes=1)
    multihost.initialize(coordinator_address=None)
    multihost.initialize(coordinator_address='localhost:1', num_processes=1)
    assert not dist.is_initialized()


@pytest.mark.parametrize('n', [1, 2, 3])
def test_local_examples_match_npp_tpu(n):
    from npp_tpu.parallel import multihost as jax_multihost
    ex = list('abcdefg')
    parts = [multihost.local_examples(ex, process_id=p, num_processes=n)
             for p in range(n)]
    assert parts == [jax_multihost.local_examples(ex, process_id=p,
                                                  num_processes=n)
                     for p in range(n)]
    assert sorted(e for p in parts for e in p) == ex
    assert multihost.local_examples(ex) == ex     # no group: everything


def test_two_process_initialize_from_environment(tmp_path):
    """Two processes join through initialize() reading npp_tpu's names
    (COORDINATOR_ADDRESS as a file:// URL here) and all-reduce rank + 1."""
    init = f'file://{tmp_path / "init"}'
    env = [{'COORDINATOR_ADDRESS': init, 'NUM_PROCESSES': '2',
            'PROCESS_ID': str(r)} for r in range(2)]
    outs = launch.spawn(launch.allreduce_probe, 2, None, timeout=DEADLINE,
                        env=env)
    assert outs == [{'rank': r, 'world': 2, 'sum': 3.0} for r in range(2)]


def test_dryrun_multichip_2():
    """The port's counterpart of __graft_entry__.dryrun_multichip: one
    sharded batched step over two CPU ranks, finite loss, and the
    pixel-sharded render."""
    out = launch.dryrun_multichip(2, timeout=DEADLINE)
    assert np.isfinite(out['loss']) and out['render_shape'] == (48, 56, 3)


def test_spawn_raises_on_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match='needs 3 ranks'):
        launch.spawn(functools.partial(launch.mesh_probe, _tree(),
                                       ('images',), (3,)), 2, 'gloo',
                     str(tmp_path / 'init'), timeout=DEADLINE)
