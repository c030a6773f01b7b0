"""bench_torch.py on the CPU: its FLOP count against bench.py's on
npp_tpu's initialised MLP, its workload against bench.py's, the card peak
table, no metric line without a card, and the control's step at a tiny
size.

Tolerances: the FLOP terms within 1e-12 relative (both are sums of exact
integer products in float64); the workload arrays bit-equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch
from npp_tpu.config import CompletionConfig as JaxCompletionConfig
from npp_tpu.config import replace as jax_replace
from npp_tpu.models.completion import COMPLETION_TASK as JAX_TASK
from npp_tpu.models.pipeline import build_components as jax_build_components
from npp_tpu_torch.config import CompletionConfig, replace
from npp_tpu_torch.device import CARD_PEAKS, card_peaks, matmul_peak
from npp_tpu_torch.models.pipeline import build_components
from npp_tpu_torch.utils.synthetic import synthetic_data
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

H100 = 'NVIDIA H100 80GB HBM3'
NO_TOWERS = dict(use_perceptual_loss=False, use_contextual_loss=False)


def test_flops_equal_bench_py_term_by_term():
    """The same analytic count from the port's nn.Linear weights (out, in)
    as bench.py's from the flax kernels (in, out) at the default config."""
    jcfg = JaxCompletionConfig()
    jdata = bench._synthetic_data(jcfg)
    comps = jax_build_components(jax_replace(jcfg, **NO_TOWERS), jdata,
                                 JAX_TASK)
    jparams = comps.model.init(jax.random.PRNGKey(0), jnp.zeros(
        (1, comps.embedder.out_dim)))['params']
    want = bench.analytic_flops_per_step(jcfg, jparams)

    cfg = CompletionConfig()
    model = build_components(replace(cfg, **NO_TOWERS), synthetic_data(0),
                             torch.device('cpu')).model
    got = bench_torch.analytic_flops_per_step(cfg, model)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    assert got['mlp'] > 0 and got['total'] == pytest.approx(
        got['mlp'] + got['contextual'] + got['perceptual'], rel=1e-15)


def test_synthetic_data_is_bench_py_workload():
    want = bench._synthetic_data(JaxCompletionConfig())
    got = synthetic_data(0)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    assert got.img.shape == (bench.H, bench.W, 3)
    assert got.patch_size == bench.PATCH_SIZE == bench_torch.PATCH_SIZE


def test_card_peak_table():
    """TF32 at the default 'bfloat16' precision, f32 under 'highest' and
    'float32'; an unknown card raises; the table holds only cards."""
    peaks = card_peaks(H100)
    assert (peaks.hbm_bytes_per_s, peaks.tf32, peaks.bf16, peaks.f32) == \
        (3.35e12, 495e12, 989e12, 67e12)
    assert matmul_peak(H100, CompletionConfig().matmul_precision) == \
        (495e12, 'tf32')
    assert matmul_peak(H100, 'highest') == (67e12, 'f32')
    assert matmul_peak(H100, 'float32') == (67e12, 'f32')
    with pytest.raises(KeyError, match='no published peaks'):
        card_peaks('TPU v5 lite')
    with pytest.raises(KeyError):
        matmul_peak('NVIDIA A100-SXM4-80GB', 'bfloat16')
    assert all(name.startswith('NVIDIA ') and 'TPU' not in name
               for name in CARD_PEAKS)


def test_main_without_a_card_prints_no_metric(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench_torch.main()
    assert exc.value.code not in (0, None)
    out = capsys.readouterr().out
    assert not any(line.lstrip().startswith('{') for line in out.splitlines())


def test_control_step_runs_on_the_cpu():
    """The reference's step pattern at a tiny size: finite losses that
    change from step to step."""
    step = bench_torch.control_step(torch.device('cpu'), h=24, w=32,
                                    patch=16, patch_num=1, topk=2, n_rand=64)
    losses = [float(step()) for _ in range(3)]
    assert all(np.isfinite(losses))
    assert losses[0] != losses[-1]


def test_metric_keys_are_bench_py_keys():
    """bench_torch.py's metric line carries bench.py's keys (bench.py:
    505-519): its fixed ones and those of its late, batched segments."""
    src = open(bench.__file__).read()
    for key in bench_torch.METRIC_KEYS:
        assert f"'{key}'" in src, key
