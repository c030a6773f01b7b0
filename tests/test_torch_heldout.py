"""Port parity on the CPU for the completion's held-out blocks and its
'best' snapshot policy (cfg.comp_heldout, cfg.comp_snapshot): the planner,
the carve, the held-out coordinates and PSNR equal to `npp_tpu`'s on the
same inputs, the eval-side views and composed outputs, and small
run_completion fits that select and re-compose a snapshot."""
import os

import numpy as np
import pytest
import torch

from npp_tpu.config import CompletionConfig as JaxCompletionConfig
from npp_tpu.config import replace as jax_replace
from npp_tpu.models import completion as JC
from npp_tpu.models import heldout as JH
from npp_tpu.models.loaders import load_completion as jax_load
from npp_tpu_torch import config as TC
from npp_tpu_torch.models import completion as TCo
from npp_tpu_torch.models import heldout as TH
from npp_tpu_torch.models.loaders import load_completion
from tests.test_e2e_completion import example_dir  # noqa: F401  (fixture)
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

CPU = torch.device('cpu')


def _random_case(seed):
    """A 60x72 known mask with a rectangular hole and scattered unknown
    pixels, and a random lattice."""
    rng = np.random.RandomState(seed)
    h, w = 60, 72
    known = (rng.rand(h, w) > 0.02).astype(np.float64)
    y0, x0 = rng.randint(15, 30), rng.randint(15, 35)
    known[y0:y0 + rng.randint(6, 14), x0:x0 + rng.randint(6, 16)] = 0
    hole = 1.0 - known
    s1 = np.array([rng.uniform(-2, 2), rng.uniform(8, 16)])
    s2 = np.array([rng.uniform(8, 16), rng.uniform(-2, 2)])
    return known, hole, s1, s2


@pytest.mark.parametrize('seed', range(4))
@pytest.mark.parametrize('n_blocks,size', [(1, None), (3, None), (2, (10, 10))])
def test_plan_heldout_rects_equal_jax(seed, n_blocks, size):
    known, hole, s1, s2 = _random_case(seed)
    for max_side in (0, 12):
        assert TH.plan_heldout_rects(known, hole, s1, s2, n_blocks, size,
                                     max_side) == \
            JH.plan_heldout_rects(known, hole, s1, s2, n_blocks, size,
                                  max_side)


@pytest.mark.parametrize('n_blocks,side', [(2, 0), (1, 10), (3, 0)])
def test_carve_coords_and_psnr_equal_jax(example_dir, n_blocks,  # noqa: F811
                                         side):
    """The carved fit-side data (mask, image, pools, extras), the held-out
    coordinates and the PSNR of a noisy render, equal bit for bit, and the
    eval-side views of both completions."""
    jcfg = jax_replace(JaxCompletionConfig(), datadir=example_dir,
                       comp_heldout=n_blocks, comp_heldout_size=side,
                       comp_snapshot='best')
    tcfg = TC.replace(TC.CompletionConfig(), datadir=example_dir,
                      comp_heldout=n_blocks, comp_heldout_size=side,
                      comp_snapshot='best')
    jdata, tdata = jax_load(jcfg), load_completion(tcfg)
    jfit, tfit = JH.carve_heldout(jdata, jcfg), TH.carve_heldout(tdata, tcfg)
    assert 'heldout_mask' in tfit.extra
    for k in ('mask', 'masked_img', 'i_train', 'i_val'):
        np.testing.assert_array_equal(getattr(tfit, k), getattr(jfit, k), k)
    assert tfit.extra['heldout_rects'] == jfit.extra['heldout_rects']
    for k in ('heldout_mask', 'heldout_gt'):
        np.testing.assert_array_equal(tfit.extra[k], jfit.extra[k], k)
    np.testing.assert_array_equal(TH.heldout_coords(tfit),
                                  JH.heldout_coords(jfit))
    pred = np.clip(tdata.img + np.random.RandomState(0).randn(
        *tdata.img.shape) * 0.05, 0, 1)
    assert TH.heldout_psnr(pred, tfit) == JH.heldout_psnr(pred, jfit)

    jviews = JC.heldout_views(jdata, jcfg)
    tviews = TCo.heldout_views(tdata, tcfg)
    assert tviews[2] is jviews[2] is True
    for tv, jv in zip(tviews[:2], jviews[:2]):
        np.testing.assert_array_equal(tv.mask, jv.mask)
        assert sorted(tv.extra) == sorted(jv.extra)
    # the eval side composes the same outputs and held-out PSNR
    tout = TCo.compose_outputs(pred.astype(np.float32), tviews[1], None,
                               'l2', CPU)
    jout = JC.compose_outputs(pred.astype(np.float32), jviews[1], None, 'l2')
    np.testing.assert_allclose(tout['heldout_psnr'], jout['heldout_psnr'],
                               rtol=1e-6)
    np.testing.assert_allclose(tout['val_psnr'], jout['val_psnr'], rtol=1e-5)
    np.testing.assert_array_equal(tout['pred_rgb_img_comp'],
                                  jout['pred_rgb_img_comp'])


def test_heldout_off_and_unplaceable_keep_the_data(example_dir):  # noqa: F811
    cfg = TC.replace(TC.CompletionConfig(), datadir=example_dir)
    data = load_completion(cfg)
    assert TH.carve_heldout(data, cfg) is data
    assert TCo.heldout_views(data, cfg) == (data, data, False)
    known, hole, s1, s2 = _random_case(0)
    assert TH.plan_heldout_rects(np.zeros_like(known), hole, s1, s2, 1) == []


BUDGET = dict(netwidth=32, netdepth=4, N_rand=256, patch_num=1,
              num_real_patch_per_sample=2, N_iters=31, i_testset=10,
              i_print=10, use_perceptual_loss=False,
              use_contextual_loss=False, comp_heldout=1,
              comp_snapshot='best')


def test_run_completion_snapshot_best(example_dir, tmp_path):  # noqa: F811
    """tests/test_heldout.py::test_run_completion_snapshot_best on the
    port: every eval carries heldout_psnr, the selected milestone's is the
    largest, and the selected set is written."""
    cfg = TC.replace(TC.CompletionConfig(), datadir=example_dir,
                     basedir=str(tmp_path / 'out'), **BUDGET)
    result, final, evals = TCo.run_completion(cfg, save=True, device='cpu')
    assert sorted(evals) == [10, 20, 30]
    assert all('heldout_psnr' in ev for ev in evals.values())
    assert final['snapshot_iter'] in (10, 20, 30)
    best = max(ev['heldout_psnr'] for ev in evals.values())
    assert final['heldout_psnr'] == pytest.approx(best, abs=1e-6)
    assert final['heldout_psnr'] == pytest.approx(
        evals[final['snapshot_iter']]['heldout_psnr'], abs=1e-6)
    assert np.isfinite(final['val_psnr']) and np.isfinite(final['val_lpips'])
    name = example_dir.rstrip('/').split('/')[-1]
    assert os.path.exists(os.path.join(str(tmp_path / 'out'),
                                       'completion_top3', name,
                                       'testset_final', 'pred_rgb_img_comp.png'))


def test_snapshot_recompose_with_adaptive_latents(example_dir,  # noqa: F811
                                                  monkeypatch):
    """tests/test_heldout.py::test_snapshot_recompose_with_adaptive_latents
    on the port: with a strictly falling held-out score the first milestone
    wins, and the final set is re-composed from its stored render and its
    copy of the adaptive latents (the metrics then equal that eval's)."""
    scores = iter([30.0, 20.0, 10.0, 5.0, 4.0, 3.0, 2.0])
    monkeypatch.setattr(TCo, 'heldout_psnr', lambda pred, data: next(scores))
    cfg = TC.replace(TC.CompletionConfig(), datadir=example_dir,
                     basedir='unused', **BUDGET)
    assert cfg.loss_type == 'robust_loss_adaptive'
    _, final, evals = TCo.run_completion(cfg, save=False, device='cpu')
    assert final['snapshot_iter'] == 10
    for k in ('img_train_loss', 'train_psnr', 'val_psnr'):
        assert final[k] == pytest.approx(evals[10][k], rel=1e-6), k
