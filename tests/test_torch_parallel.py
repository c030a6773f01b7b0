"""The port's sharded paths on the CPU (the mesh= arguments and
parallel/batch.py::make_sharded_render), as tests/test_parallel.py holds
npp_tpu's on 8 virtual devices. Ranks are gloo processes started by
npp_tpu_torch/parallel/launch.py::spawn (a file:// init under the test's
tmp_path, a 60-s timeout on the group and a 60-s deadline that kills the
ranks and fails the test, one torch thread each, and every rank checks
that it holds no JAX); the JAX side and the unsharded port run here.

- make_sharded_render at two ranks: equal to the port's make_render
  within 1e-6 (1,920 coordinates in chunks of 256: the last chunk is a
  partial GEMM there and a padded one here), and to npp_tpu's
  make_sharded_render on a 2-device ('pixels',) mesh at
  tests/test_torch_nn.py's tolerances (embedding 1e-4 absolute, MLP 1e-4
  relative);
- fit_images at two ranks on three images (one padding image): every
  image's parameters and Adam moments equal to the unsharded fit_images
  at tests/test_torch_batch.py's rtol 5e-4, atol 5e-5. Not bit for bit:
  the stacked pixel loss lays the images' 3B columns side by side in one
  K4 segment (losses/robust.py), and the plain version's column
  reductions in the latents' gradient group by that width (9 columns at
  three images, 6 at two a rank), which moved latent_alpha by 4.7e-10
  (one ulp) in ten steps;
- one batched step sharded over two ranks, from npp_tpu's init on
  injected batches, against npp_tpu's make_batched_fit_step on a
  2-device mesh, at tests/test_torch_batch.py::
  test_batched_step_matches_npp_tpu's tolerances (metrics 1e-4 relative,
  Adam's first moment 2e-3 of its largest value);
- rank_proposals with candidates meshes of 2 and 4 on
  tests/test_parallel.py's image and candidates: the held-out MSE and
  the LPIPS components equal to the unsharded call at rtol 1e-5, atol
  1e-6, the tolerance npp_tpu holds itself to; the CX components and the
  distances at rtol 1e-3. CX's sharp softmax carries the CPU
  convolutions' rounding, which depends on how many candidates share a
  call (relu3_4 features of one crop 1.1e-5 apart, of values up to 12,
  alone against beside another), to 1.5e-4 of the score (measured
  1.8e-4 of the distance here); on the card, where the check is 1e-4
  in full f32, the sharded ranking read 1.7e-5;
- rank_proposals_suite at two ranks over three images: each image's
  distances equal to the unsharded suite's at rtol 1e-5, atol 1e-6 (an
  image's candidates share one call either way)."""
import concurrent.futures
import functools

import jax
import numpy as np
import pytest
import torch

from npp_tpu_torch import config as TC
from npp_tpu_torch.models import trainer as TT
from npp_tpu_torch.parallel import launch
from npp_tpu_torch.parallel.runner import fit_images
from npp_tpu_torch.proposal import ranking as TR
from npp_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_batch import PLAIN, _data
from tests.test_torch_trainer import TINY, _assert_scaled, _tiny_arrays
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

CPU = torch.device('cpu')
DEADLINE = 60.0
H, W, CHUNK = 40, 48, 256


def _spawn(world, tmp_path, *calls):
    """The calls in turn in one group of `world` gloo ranks."""
    return launch.spawn(functools.partial(launch.in_turn, *calls), world,
                        'gloo', str(tmp_path / 'init'), timeout=DEADLINE)


# ---- the render and fit_images: one two-rank group ----------------------

@pytest.fixture(scope='module')
def render_inputs():
    """npp_tpu's NPPNet parameters and embedder at the tiny example, and
    the port's FitParams and TaskEmbedder holding them."""
    from npp_tpu.config import CompletionConfig as JaxConfig
    from npp_tpu.config import replace as jax_replace
    from npp_tpu.nn.embedder import make_task_embedder as jax_embedder
    from npp_tpu.nn.mlp import NPPNet as JaxNPPNet
    from npp_tpu_torch.losses.robust import adaptive_init
    from npp_tpu_torch.nn.embedder import make_task_embedder
    from npp_tpu_torch.nn.mlp import NPPNet
    a = _tiny_arrays(H, W)
    angles, periods = (np.asarray(a[k]) for k in ('selected_angles',
                                                  'selected_periods'))
    jcfg = jax_replace(JaxConfig(), netwidth=32, netdepth=4)
    jemb = jax_embedder(jcfg, angles, periods, (H, W), jax.random.PRNGKey(0))
    jmodel = JaxNPPNet(input_ch_periodic=jemb.top1_dim,
                       input_ch_periodic_aux=jemb.out_dim - jemb.top1_dim,
                       depth=4, width=32, activation=jcfg.activation)
    jparams = jmodel.init(jax.random.PRNGKey(1),
                          jax.numpy.zeros((1, jemb.out_dim)))['params']
    cfg = TC.replace(TC.CompletionConfig(), netwidth=32, netdepth=4,
                     matmul_precision='float32')
    emb = make_task_embedder(cfg, angles, periods, (H, W),
                             torch.Generator().manual_seed(0), CPU)
    emb.freq_bands = torch.tensor(np.asarray(jemb.freq_bands))
    mlp = NPPNet(emb.top1_dim, emb.out_dim - emb.top1_dim, depth=4, width=32)
    mlp.load_state_dict(params_from_jax(
        {'mlp': jax.tree.map(np.asarray, jparams)})['mlp'])
    return dict(jcfg=jcfg, jemb=jemb, jmodel=jmodel, jparams=jparams,
                cfg=cfg, emb=emb, params=TT.FitParams(mlp, adaptive_init(3)))


FIT_CFG = TC.replace(TC.CompletionConfig(), N_iters=11, i_testset=10,
                     i_print=10, **PLAIN)


@pytest.fixture(scope='module')
def render_and_fit(render_inputs, tmp_path_factory):
    """Two ranks: the pixel-sharded render, then fit_images over the
    'images' axis (three images, padded to four)."""
    r = render_inputs
    datas = [_data(), _data(seed=2), _data(seed=3)]
    outs = _spawn(2, tmp_path_factory.mktemp('render_fit'),
                  functools.partial(launch.render_sharded, r['cfg'], r['emb'],
                                    r['params'], H, W, chunk=CHUNK),
                  functools.partial(launch.with_mesh, ('images',), None,
                                    fit_images, FIT_CFG, TT.COMPLETION_TASK,
                                    datas, canvas_multiple=16, device='cpu'))
    return datas, outs


def test_sharded_render_equals_make_render(render_inputs, render_and_fit):
    r = render_inputs
    _, outs = render_and_fit
    want = TT.make_render(r['cfg'], r['emb'], chunk=CHUNK)(r['params'], H,
                                                          W).numpy()
    for rank_out in outs:
        got = rank_out[0]
        assert got.shape == (H, W, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_sharded_render_matches_npp_tpu(render_inputs, render_and_fit):
    from npp_tpu.parallel.batch import make_sharded_render
    from npp_tpu.parallel.mesh import make_mesh
    r = render_inputs
    _, outs = render_and_fit
    pmesh = make_mesh(('pixels',), (2,), devices=jax.devices()[:2])
    want = np.asarray(make_sharded_render(r['jcfg'], r['jmodel'], pmesh,
                                          chunk=CHUNK)(r['jparams'],
                                                       r['jemb'], H, W))
    np.testing.assert_allclose(outs[0][0], want, rtol=1e-4, atol=1e-4)


def test_sharded_fit_images_equals_unsharded(render_and_fit):
    """Each image draws from its own generator and its fit does not depend
    on the rank or the images beside it: the same parameters, Adam
    moments and step on both ranks (up to the pixel loss's column
    grouping, see the module note)."""
    datas, outs = render_and_fit
    plain = fit_images(FIT_CFG, TT.COMPLETION_TASK, datas,
                       canvas_multiple=16, device='cpu')
    for rank_out in outs:
        states = rank_out[1]
        assert len(states) == 3
        for st, want in zip(states, plain):
            want = launch.to_host(want)
            assert st['step'] == want['step'] == 10
            for part in ('params', 'exp_avg', 'exp_avg_sq'):
                assert st[part].keys() == want[part].keys()
                for k in want[part]:
                    np.testing.assert_allclose(st[part][k], want[part][k],
                                               rtol=5e-4, atol=5e-5,
                                               err_msg=f'{part} {k}')


# ---- one sharded batched step against npp_tpu's ---------------------------

def test_sharded_batched_step_matches_npp_tpu(monkeypatch, tmp_path):
    """npp_tpu's make_batched_fit_step on a 2-device 'images' mesh and the
    port's step with the images over two ranks (launch.py::
    sharded_fit_step), from npp_tpu's init, on the same injected 'same'
    batch for both images and npp_tpu's pixel draws."""
    from npp_tpu.config import CompletionConfig as JaxConfig
    from npp_tpu.config import replace as jax_replace
    from npp_tpu.models import sampler as JS
    from npp_tpu.models import trainer as JT
    from npp_tpu.models.completion import COMPLETION_TASK as JTASK
    from npp_tpu.models.loaders import TaskData as JaxTaskData
    from npp_tpu.models.pipeline import build_components, make_fit_consts
    from npp_tpu.nn.embedder import make_task_embedder as jax_embedder
    from npp_tpu.parallel import batch as JB
    from npp_tpu.parallel.mesh import make_mesh, shard_leading_axis
    from npp_tpu.parallel.runner import _pad_pools_to_common
    from npp_tpu.parallel.runner import pad_to_canvas as jax_pad
    from npp_tpu_torch.models import sampler as TS
    from npp_tpu_torch.models.loaders import TaskData

    jcfg = jax_replace(JaxConfig(), matmul_precision='float32', **TINY)
    arrays = [_tiny_arrays(), _tiny_arrays(36, 44)]
    jdatas = [JaxTaskData(**a) for a in arrays]
    dims = [d.img.shape[:2] for d in jdatas]
    jdatas = [jax_pad(d, 40, 48) for d in jdatas]
    jembs = [jax_embedder(jcfg, np.asarray(d.selected_angles),
                          np.asarray(d.selected_periods), dims[j],
                          jax.random.PRNGKey(jcfg.seed))
             for j, d in enumerate(jdatas)]
    comps = build_components(jcfg, jdatas[0], JTASK)
    state, tx = JB.init_batched_state(jcfg, JTASK, comps.model, jembs,
                                      jax.random.PRNGKey(0), comps.percep,
                                      None)
    consts = _pad_pools_to_common([make_fit_consts(jcfg, JTASK, d, 16)
                                   for d in jdatas])
    for i in range(100):
        batch = JS.sample_patches(jax.random.PRNGKey(i), consts[0].sampler, 1,
                                  16, 2, jcfg.invalid_ratio)
        if int(batch.source) == JS.SOURCE_SAME:
            break
    key = jax.random.PRNGKey(7)
    pix = [torch.tensor(np.asarray(jax.random.randint(
        jax.random.split(key)[0], (jcfg.N_rand,), 0, c.pool_train_n))).long()
        for c in consts]
    cfg = TC.replace(TC.CompletionConfig(), matmul_precision='float32',
                     **TINY)
    npy = jax.tree.map(np.asarray, state.params)
    params = [params_from_jax(jax.tree.map(
        lambda x, jj=j: x[jj], {'mlp': npy['mlp'],
                                'adaptive_pix': npy['adaptive_pix'],
                                'adaptive_percep': npy['adaptive_percep']}))
        for j in range(2)]
    tbatch = TS.PatchBatch(*[torch.tensor(np.asarray(v)) for v in
                             batch[:-1]], int(batch.source))
    tbatch.fake_coords = tbatch.fake_coords.long()
    # the ranks run while npp_tpu's step compiles here
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.spawn, functools.partial(
            launch.sharded_fit_step, cfg, [TaskData(**a) for a in arrays],
            params=params, inject=(pix, [tbatch, tbatch]),
            bands=np.asarray(jembs[0].freq_bands)), 2, 'gloo',
            str(tmp_path / 'init'), timeout=DEADLINE)
        monkeypatch.setattr(JT, 'sample_patches', lambda *a, **k: batch)
        mesh = make_mesh(('images',), (2,), devices=jax.devices()[:2])
        step = JB.make_batched_fit_step(jcfg, JTASK, comps.model,
                                        comps.percep, comps.contextual, None,
                                        tx, 1, 16, mesh=mesh)
        new_state, jm = step(shard_leading_axis(state, mesh),
                             JB.stack_embedders(jembs),
                             shard_leading_axis(JB.stack_consts(consts),
                                                mesh), key)
        out = ranks.result()
    mu = [s.mu for s in jax.tree.leaves(
        new_state.opt_state, is_leaf=lambda x: hasattr(x, 'mu'))
        if hasattr(s, 'mu')][0]
    jmu = jax.tree.map(np.asarray, mu)
    for rank_out in out:
        m = rank_out['metrics']
        np.testing.assert_allclose(m['loss'], float(jm['loss']), rtol=1e-4)
        for k in ('pixel', 'contextual', 'perceptual'):
            np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        for j, st in enumerate(rank_out['states']):
            for name, p in jmu['mlp'].items():
                _assert_scaled(st['exp_avg'][f'mlp.{name}.weight'],
                               p['kernel'][j].T, 2e-3, name)
                _assert_scaled(st['exp_avg'][f'mlp.{name}.bias'],
                               p['bias'][j], 2e-3, name)


# ---- the ranking over candidates and over images -------------------------

RANK_CFG = TC.replace(TC.SearchConfig(), netdepth=2, netwidth=32, N_rand=64,
                      N_iters=20)


def _rank_image():
    """tests/test_parallel.py::test_ranking_candidate_axis_sharded's
    image, split and candidates."""
    h, w = 64, 72
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    img = np.clip(np.stack([0.5 + 0.45 * np.sin(2 * np.pi * yy / 12.0),
                            0.5 + 0.45 * np.cos(2 * np.pi * xx / 16.0),
                            0.5 * np.ones((h, w))], -1), 0, 1)
    val_mask = (yy > 24) & (yy < 40) & (xx > 28) & (xx < 44)
    i_val = np.stack(np.nonzero(val_mask), 1)
    i_train = np.stack(np.nonzero(~val_mask), 1)
    return img, i_train, i_val, [[90.0, 180.0], [90.0, 180.0]], \
        [[16.0, 12.0], [7.0, 5.0]]


def _suite_items():
    """Three images on one canvas with 2, 3 and 1 candidates."""
    img, i_train, i_val, angles, periods = _rank_image()
    imgs = [img, np.roll(img, 5, axis=1), img[..., ::-1].copy()]
    cands = [(angles, periods),
             (angles + [[45.0, 135.0]], periods + [[11.5, 23.0]]),
             (angles[1:], periods[1:])]
    return [{'masked_img': m, 'i_train': i_train, 'i_val': i_val,
             'all_angles': a, 'all_periods': p, 'norm_res': (64, 72)}
            for m, (a, p) in zip(imgs, cands)]


@pytest.fixture(scope='module')
def towers():
    from npp_tpu_torch.losses.contextual import ContextualLoss
    from npp_tpu_torch.losses.lpips import LPIPS
    return LPIPS(CPU, net='vgg'), ContextualLoss(CPU)


@pytest.fixture(scope='module')
def ranked_two_ranks(towers, tmp_path_factory):
    """Two ranks: rank_proposals over a 'candidates' axis of 2, then
    rank_proposals_suite over an 'images' axis of 2 (three images)."""
    percep, cx = towers
    return _spawn(2, tmp_path_factory.mktemp('rank2'),
                  functools.partial(launch.with_mesh, ('candidates',), None,
                                    TR.rank_proposals, RANK_CFG,
                                    *_rank_image(), percep, cx,
                                    return_components=True, device='cpu'),
                  functools.partial(launch.with_mesh, ('images',), None,
                                    TR.rank_proposals_suite, RANK_CFG,
                                    _suite_items(), percep, cx,
                                    device='cpu'))


@pytest.fixture(scope='module')
def plain_ranking(towers):
    return TR.rank_proposals(RANK_CFG, *_rank_image(), *towers,
                             return_components=True, device='cpu')


@pytest.mark.parametrize('parts', [2, 4])
def test_ranking_candidate_axis_sharded(parts, towers, plain_ranking,
                                        ranked_two_ranks, tmp_path):
    if parts == 2:
        outs = [o[0] for o in ranked_two_ranks]
    else:
        outs = launch.spawn(functools.partial(
            launch.with_mesh, ('candidates',), None, TR.rank_proposals,
            RANK_CFG, *_rank_image(), *towers, return_components=True,
            device='cpu'), 4, 'gloo', str(tmp_path / 'init'),
            timeout=DEADLINE)
    want_d, want = plain_ranking
    for got_d, got in outs:
        assert got_d.shape == want_d.shape == (2,)
        assert got.keys() == want.keys()
        for k in ('val_mse', 'lpips_bbox', 'lpips_comp'):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        for k in ('cx_bbox', 'cx_comp'):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
        np.testing.assert_allclose(got_d, want_d, rtol=1e-3)


def test_ranking_suite_images_sharded(towers, ranked_two_ranks):
    plain = TR.rank_proposals_suite(RANK_CFG, _suite_items(), *towers,
                                    device='cpu')
    for rank_out in ranked_two_ranks:
        got = rank_out[1]
        assert [len(d) for d, _ in got] == [2, 3, 1]
        for (d, comps), (want, want_comps) in zip(got, plain):
            np.testing.assert_allclose(d, want, rtol=1e-5, atol=1e-6)
            assert comps.keys() == want_comps.keys()
