"""The seam-aware residual composite (cfg.comp_seam,
models/completion.py::seam_residual_correction) on the CPU against
`npp_tpu`'s, whose cv2.inpaint the port replaces with its own library
(ops/inpaint.py): compose_outputs of both packages on the same injected
render, and small run_completion fits with comp_seam 'residual' and
'none' (the final evals make the seam outputs either way)."""
import os

import numpy as np
import pytest
import torch

from npp_tpu.config import CompletionConfig as JaxCompletionConfig
from npp_tpu.config import replace as jax_replace
from npp_tpu.models import completion as JC
from npp_tpu.models.loaders import load_completion as jax_load
from npp_tpu_torch import config as TC
from npp_tpu_torch.models import completion as TCo
from npp_tpu_torch.models.loaders import load_completion
from tests.test_e2e_completion import example_dir  # noqa: F401  (fixture)
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

CPU = torch.device('cpu')
SEAM_KEYS = ('pred_rgb_img_comp_seam', 'val_psnr_seam', 'val_lpips_seam')


@pytest.mark.parametrize('normalize_type', [1, 2])
@pytest.mark.parametrize('comp_seam', ['none', 'residual'])
def test_compose_outputs_seam_matches_jax(example_dir, normalize_type,  # noqa: F811
                                          comp_seam):
    """On the same render (the image, a low-frequency tint and noise),
    the seam composite within 1e-6 of npp_tpu's and val_psnr_seam within
    1e-4 dB; under 'residual' pred_rgb_img_comp is the seam composite,
    and with compute_seam left at None 'none' makes no seam outputs."""
    data = load_completion(TC.replace(TC.CompletionConfig(),
                                      datadir=example_dir))
    jdata = jax_load(jax_replace(JaxCompletionConfig(), datadir=example_dir))
    h, w = data.img.shape[:2]
    rng = np.random.RandomState(normalize_type)
    yy = np.linspace(0, 1, h)[:, None, None]
    pred = (data.img + 0.08 * np.sin(3 * yy + np.arange(3)) +
            rng.randn(h, w, 3) * 0.03).astype(np.float32)
    kw = dict(comp_seam=comp_seam, normalize_type=normalize_type)
    for compute_seam in (None, True):
        got = TCo.compose_outputs(pred, data, None, 'l2', CPU,
                                  compute_seam=compute_seam, **kw)
        want = JC.compose_outputs(pred, jdata, None, 'l2',
                                  compute_seam=compute_seam, **kw)
        assert sorted(got) == sorted(want)
        if 'pred_rgb_img_comp_seam' not in want:
            assert compute_seam is None and comp_seam == 'none'
            continue
        np.testing.assert_allclose(got['pred_rgb_img_comp_seam'],
                                   want['pred_rgb_img_comp_seam'],
                                   rtol=0, atol=1e-6)
        assert abs(got['val_psnr_seam'] - want['val_psnr_seam']) < 1e-4
        np.testing.assert_allclose(got['pred_rgb_img_comp'],
                                   want['pred_rgb_img_comp'], atol=1e-6)
        if comp_seam == 'residual':
            assert got['pred_rgb_img_comp'] is got['pred_rgb_img_comp_seam']
        # the correction moved the hole towards the truth
        assert got['val_psnr_seam'] > got['val_psnr']


def test_seam_residual_correction_matches_jax():
    """The correction alone, float64 on the host: the same array as
    npp_tpu's (cv2 against the port's library, then the same numpy),
    with the uint8 cast truncating and err 0 outside the known region."""
    rng = np.random.RandomState(3)
    h, w = 30, 40
    pred = rng.rand(h, w, 3)
    masked = np.clip(pred + rng.randn(h, w, 3) * 0.1, 0, 1)
    hole = np.zeros((h, w))
    hole[8:20, 10:30] = 1
    known = 1 - hole
    known[0, :] = 0      # invalid pixels: neither known nor hole
    for vr in (1.0, 2.0):
        np.testing.assert_array_equal(
            TCo.seam_residual_correction(pred, masked, known, hole, vr),
            JC.seam_residual_correction(pred, masked, known, hole, vr))


BUDGET = dict(netwidth=32, netdepth=4, N_rand=256, patch_num=1,
              num_real_patch_per_sample=2, N_iters=21, i_testset=10,
              i_print=10, use_perceptual_loss=False,
              use_contextual_loss=False)
MARGIN_DB = 2.0


def test_run_completion_residual_tracks_jax(example_dir, tmp_path):  # noqa: F811
    """comp_seam='residual' end to end against npp_tpu's at the same
    budget. The packages draw different random numbers, so the comparison
    is at the trajectory level (PARITY.md deviation 1), as
    tests/test_torch_e2e.py's: val_psnr_seam no more than 2 dB below
    npp_tpu's. pred_rgb_img_comp is the seam composite; every eval makes
    the seam outputs under 'residual', and each testset has its PNG."""
    _, jfinal, jevals = JC.run_completion(jax_replace(
        JaxCompletionConfig(), datadir=example_dir, comp_seam='residual',
        basedir=str(tmp_path / 'jax'), **BUDGET), save=False)
    cfg = TC.replace(TC.CompletionConfig(), datadir=example_dir,
                     comp_seam='residual', basedir=str(tmp_path / 'port'),
                     **BUDGET)
    _, final, evals = TCo.run_completion(cfg, save=True, device='cpu')
    assert set(final) == set(jfinal)
    assert final['val_psnr_seam'] > jfinal['val_psnr_seam'] - MARGIN_DB, (
        final['val_psnr_seam'], jfinal['val_psnr_seam'])
    np.testing.assert_array_equal(final['pred_rgb_img_comp'],
                                  final['pred_rgb_img_comp_seam'])
    assert np.isfinite(final['val_lpips_seam'])
    assert final['val_lpips'] == final['val_lpips_seam']
    assert all('val_psnr_seam' in ev for ev in evals.values())
    assert sorted(evals) == sorted(jevals)
    name = example_dir.rstrip('/').split('/')[-1]
    out = os.path.join(str(tmp_path / 'port'), 'completion_top3', name)
    for d in ('testset_000010', 'testset_000020', 'testset_final'):
        assert os.path.exists(os.path.join(out, d,
                                           'pred_rgb_img_comp_seam.png')), d


def test_run_completion_default_has_seam_outputs(example_dir, tmp_path):  # noqa: F811
    """At the default comp_seam='none' the final dict still holds the
    seam outputs (npp_tpu/models/completion.py:221-234), the last testset
    and testset_final have the seam PNG, an earlier testset has not, and
    pred_rgb_img_comp stays the plain composite."""
    cfg = TC.replace(TC.CompletionConfig(), datadir=example_dir,
                     basedir=str(tmp_path), **BUDGET)
    assert cfg.comp_seam == 'none'
    _, final, evals = TCo.run_completion(cfg, save=True, device='cpu')
    for k in SEAM_KEYS:
        assert k in final, k
    assert np.isfinite(final['val_psnr_seam'])
    assert 'val_psnr_seam' in evals[20] and 'val_psnr_seam' not in evals[10]
    assert not np.array_equal(final['pred_rgb_img_comp'],
                              final['pred_rgb_img_comp_seam'])
    name = example_dir.rstrip('/').split('/')[-1]
    out = os.path.join(str(tmp_path), 'completion_top3', name)
    seam_png = 'pred_rgb_img_comp_seam.png'
    assert os.path.exists(os.path.join(out, 'testset_final', seam_png))
    assert os.path.exists(os.path.join(out, 'testset_000020', seam_png))
    assert not os.path.exists(os.path.join(out, 'testset_000010', seam_png))
