"""Checkpoints and the metrics stream of the port's fit_image on the CPU.

A saved state loads back equal; a fit of 2N steps equals a fit of N steps
and a resume of N more (bit for bit: the file carries Adam's state and the
batch generator's, and the CPU repeats its arithmetic); the JSONL stream
has npp_tpu's event kinds and keys for the same tiny fit."""
import json

import numpy as np
import pytest
import torch

from npp_tpu_torch import config as TC
from npp_tpu_torch.models.loaders import TaskData
from npp_tpu_torch.models.pipeline import fit_image
from npp_tpu_torch.utils import checkpoint as CK
from npp_tpu_torch.utils.debug import MetricLogger, PhaseTimer, trace
from tests.test_torch_trainer import TINY, _tiny_arrays
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

N = 8


def _cfg(n_iters, **kw):
    return TC.replace(TC.CompletionConfig(), N_iters=n_iters, i_testset=N,
                      i_print=N, matmul_precision='float32', **TINY, **kw)


def _fit(cfg, **kw):
    return fit_image(cfg, TaskData(**_tiny_arrays()), log_every=cfg.i_print,
                     device='cpu', **kw)


def test_state_round_trip(tmp_path):
    res = _fit(_cfg(N + 1))
    gen = torch.Generator().manual_seed(5)
    torch.rand(3, generator=gen)
    path = str(tmp_path / 'c' / 'step_8.pt')
    CK.save_fit_state(path, res.state, gen)
    fresh = _fit(_cfg(2))           # another state of the same structure
    gen2 = torch.Generator().manual_seed(0)
    CK.restore_fit_state(path, fresh.state, gen2)
    assert fresh.state.step == res.state.step == N
    for (k, a), (_, b) in zip(res.state.params.state_dict().items(),
                              fresh.state.params.state_dict().items()):
        assert torch.equal(a, b), k
    sa, sb = (s.optimizer.state_dict()['state']
              for s in (res.state, fresh.state))
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=gen2))
    assert CK.latest_checkpoint(str(tmp_path / 'c')) == path
    assert CK.latest_checkpoint(str(tmp_path / 'none')) is None


def test_resume_equals_uninterrupted_fit(tmp_path):
    """2N steps in one go against N steps, stopped, and a resume of N."""
    whole = _fit(_cfg(2 * N + 1))
    d = str(tmp_path / 'ckpt')
    first = _fit(_cfg(N + 1), checkpoint_dir=d)
    assert CK.latest_checkpoint(d).endswith(f'step_{N}.pt')
    resumed = _fit(_cfg(2 * N + 1), checkpoint_dir=d)
    assert first.state.step == N and resumed.state.step == 2 * N
    assert [h['iter'] for h in resumed.history] == [2 * N]
    for (k, a), (_, b) in zip(whole.state.params.state_dict().items(),
                              resumed.state.params.state_dict().items()):
        assert torch.equal(a, b), k
    assert CK.latest_checkpoint(d).endswith(f'step_{2 * N}.pt')


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_metrics_stream_matches_npp_tpu(tmp_path):
    """The same tiny fit (3 steps, a log at each) through both packages:
    the same sequence of event kinds, each with the same keys."""
    from npp_tpu.config import CompletionConfig as JaxConfig
    from npp_tpu.config import replace as jax_replace
    from npp_tpu.models.completion import COMPLETION_TASK
    from npp_tpu.models.loaders import TaskData as JaxTaskData
    from npp_tpu.models.pipeline import fit_image as jax_fit
    kw = dict(N_iters=4, i_print=1, i_testset=2, matmul_precision='float32',
              **TINY)
    jax_fit(jax_replace(JaxConfig(), **kw), COMPLETION_TASK,
            JaxTaskData(**_tiny_arrays()), log_every=1,
            metrics_path=str(tmp_path / 'jax.jsonl'))
    cfg = TC.replace(TC.CompletionConfig(), **kw)
    fit_image(cfg, TaskData(**_tiny_arrays()), log_every=1, device='cpu',
              metrics_path=str(tmp_path / 'port' / 'm.jsonl'))
    want = _events(tmp_path / 'jax.jsonl')
    got = _events(tmp_path / 'port' / 'm.jsonl')
    assert [e['kind'] for e in got] == [e['kind'] for e in want] == \
        ['train'] * 3 + ['fit_done']
    for g, w in zip(got, want):
        assert set(g) == set(w), (sorted(g), sorted(w))
    assert [e['iter'] for e in got[:3]] == [1, 2, 3]
    assert got[-1]['iters'] == want[-1]['iters'] == 3


def test_debug_helpers(tmp_path):
    timer = PhaseTimer()
    with timer.phase('a'):
        pass
    assert 'a=' in timer.summary()
    log = MetricLogger(str(tmp_path / 'l.jsonl'))
    log.log(kind='x', v=1)
    log.close()
    assert _events(tmp_path / 'l.jsonl')[0]['v'] == 1
    MetricLogger(None).log(kind='nothing')
    with trace(str(tmp_path / 'tr')):
        torch.ones(3).sum()
    with open(tmp_path / 'tr' / 'trace.json') as f:
        assert 'traceEvents' in json.load(f)
    np.testing.assert_equal(torch.is_anomaly_enabled(), False)
