"""Port parity on the CPU for the segmentation's fit and refinement: the
AlexNet tower, LPIPS-alex in spatial mode per layer, the refinement on the
reference-executed golden and under each of npp_tpu's gated options, one
segmentation fit step on an injected batch, and `run_segmentation` end to
end at a small size."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npp_tpu.config import SegmentationConfig as JaxSegConfig
from npp_tpu.config import replace as jax_replace
from npp_tpu.losses.lpips import LPIPS as JaxLPIPS
from npp_tpu.models import pipeline as JP
from npp_tpu.models import sampler as JS
from npp_tpu.models import trainer as JT
from npp_tpu.models.loaders import TaskData as JaxTaskData
from npp_tpu.models.segmentation import SEGMENTATION_TASK as JAX_SEG_TASK
from npp_tpu.models.segmentation import refine_segmentation as jax_refine
from npp_tpu.nn.features import AlexNetFeatures as JaxAlex
from npp_tpu_torch import config as TC
from npp_tpu_torch.losses.lpips import LPIPS, upsample_bilinear
from npp_tpu_torch.models import pipeline as TP
from npp_tpu_torch.models import sampler as TSa
from npp_tpu_torch.models import trainer as TT
from npp_tpu_torch.models.loaders import TaskData, segmentation_data
from npp_tpu_torch.models.segmentation import (SEGMENTATION_TASK,
                                               refine_segmentation,
                                               run_segmentation)
from npp_tpu_torch.utils.convert import params_from_jax
from npp_tpu_torch.utils.synthetic import synthetic_segment_data
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

CPU = torch.device('cpu')
GOLDEN = os.path.join(os.path.dirname(__file__), 'goldens',
                      'seg_criterion_parity.npz')
TINY = dict(netwidth=32, netdepth=6, N_rand=64, patch_num=1,
            num_real_patch_per_sample=2)


@pytest.fixture(scope='module')
def alex():
    """Both packages' LPIPS-alex (the analytic tower is generated once)."""
    return {'j': JaxLPIPS(net='alex'), 't': LPIPS(CPU, net='alex')}


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_alexnet_features_match_jax(alex):
    """The torchvision-layout tower (owt=False): the same analytic weights
    (after HWIO -> OIHW) and every tap within 1e-5 of its largest value."""
    x = np.random.RandomState(0).rand(2, 70, 90, 3).astype(np.float32)
    jouts = JaxAlex(owt=False).apply({'params': alex['j'].params},
                                     jnp.asarray(x))
    w = alex['t'].tower.params['conv0'][0].numpy().transpose(2, 3, 1, 0)
    np.testing.assert_array_equal(w, np.asarray(
        alex['j'].params['conv0']['kernel']))
    touts = alex['t'].tower(torch.tensor(x).permute(0, 3, 1, 2),
                            ('conv1', 'relu1', 'relu2', 'relu3', 'relu4',
                             'relu5'))
    for tap, t in touts.items():
        got = t.permute(0, 2, 3, 1).numpy()
        assert got.shape == jouts[tap].shape, tap
        assert _scaled_err(got, jouts[tap]) <= 1e-5, tap


@pytest.mark.parametrize('src,dst', [((63, 80), (256, 320)),
                                     ((23, 31), (96, 128)), ((5, 7), (96, 128))])
def test_upsample_matches_jax_image_resize(src, dst):
    """F.interpolate(align_corners=False) against jax.image.resize's
    bilinear up-sampling at alex's non-integer ratios (63 -> 256 is relu1
    of a 256-row image): within 1e-6 of the largest value."""
    m = np.random.RandomState(1).rand(2, *src, 1).astype(np.float32)
    want = jax.image.resize(jnp.asarray(m), (2, *dst, 1), method='bilinear')
    got = upsample_bilinear(torch.tensor(m), *dst).numpy()
    assert _scaled_err(got, want) <= 1e-6


def test_lpips_alex_spatial_per_layer_matches_jax(alex):
    """The refinement's call: one-channel gray images (broadcast against
    the three-channel shift and scale), normalize, spatial, per layer.
    Every layer's up-sampled map and the total within rtol 1e-4 of its
    largest value."""
    rng = np.random.RandomState(2)
    a = rng.rand(1, 96, 128, 1).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(1, 96, 128, 1), 0, 1).astype(np.float32)
    jv, jres = alex['j'](jnp.asarray(a), jnp.asarray(b), normalize=True,
                         spatial=True, ret_per_layer=True)
    with torch.no_grad():
        tv, tres = alex['t'](torch.tensor(a), torch.tensor(b),
                             normalize=True, spatial=True, ret_per_layer=True)
    assert tv.shape == (1, 96, 128, 1) and len(tres) == 5
    assert _scaled_err(tv.numpy(), jv) <= 1e-4
    for t, j in zip(tres, jres):
        assert _scaled_err(t.numpy(), j) <= 1e-4


def _data(blur, non_period, mask=None, valid=None):
    h, w = blur.shape[:2]
    kw = dict(img=blur, masked_img=blur,
              mask=np.ones((h, w, 1)) if mask is None else mask,
              valid_mask=np.ones((h, w, 1)) if valid is None else valid,
              i_train=np.zeros((1, 2), np.int64),
              i_val=np.zeros((1, 2), np.int64),
              selected_shifts=[], selected_angles=[], selected_periods=[],
              patch_size=16,
              extra={'blur_img': blur, 'non_period_mask': non_period})
    return TaskData(**kw), JaxTaskData(**kw)


def test_refinement_reproduces_the_reference_golden(alex):
    """tests/goldens/seg_criterion_parity.npz (the reference's chain run
    with this tower; tests/test_pipeline_parity.py:262-269's tolerances):
    L1 map rtol 1e-5 / atol 1e-6, the LPIPS map rtol 5e-4 / atol 5e-5, both
    threshold masks and the final mask exactly."""
    g = np.load(GOLDEN)
    l1_t, lp_t, n_layers = g['thresholds']
    cfg = TC.replace(TC.SegmentationConfig(), seg_autocal='off',
                     l1_thresh=float(l1_t), lpips_thresh=float(lp_t),
                     lpips_layers=int(n_layers))
    data, _ = _data(g['blur'], g['init_np'][..., None].astype(np.float64),
                    mask=1.0 - g['init_np'][..., None].astype(np.float64),
                    valid=g['valid'])
    res = refine_segmentation(cfg, data, np.asarray(g['pred']), alex['t'])
    np.testing.assert_allclose(res['l1_img'], g['l1_img'], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(res['l1_mask'], g['l1_mask'])
    np.testing.assert_allclose(res['lpips_maps'][0], g['lpips_map_0'],
                               rtol=5e-4, atol=5e-5)
    np.testing.assert_array_equal(res['lpips_masks'][0], g['lpips_mask_0'])
    np.testing.assert_array_equal(res['non_period_mask'][..., 0] > 0,
                                  g['final_mask'])


def _blob_scene():
    """tests/test_segmentation.py's autocalibration scene: a badly
    reconstructed block inside an init non-periodic square."""
    rng = np.random.RandomState(0)
    h, w = 96, 96
    blur = rng.rand(h, w, 3) * 0.05 + 0.5
    pred = blur.copy()
    pred[30:80, 30:80] += rng.rand(50, 50, 3) * 0.6
    non_period = np.zeros((h, w, 1))
    non_period[20:90, 20:90] = 1
    return blur, pred, non_period


def _band_scene():
    """tests/test_segmentation.py's hysteresis scene: a blob core far over
    the L1 threshold, a band just under it and a near-zero overshoot."""
    rng = np.random.RandomState(3)
    h, w = 128, 128
    blur = rng.rand(h, w, 3) * 0.05 + 0.5
    pred = blur.copy()
    pred[40:60, 40:60] += 0.6
    band = np.zeros((h, w), bool)
    band[30:70, 30:70] = True
    band[40:60, 40:60] = False
    pred[band] = blur[band] + 0.8 * 0.15
    non_period = np.zeros((h, w, 1))
    non_period[20:80, 20:80] = 1
    return blur, pred, non_period


def _plate_scene():
    """tests/test_segmentation.py's texture scene: a smooth plate in a
    periodic texture, rendered perfectly."""
    rng = np.random.RandomState(5)
    h, w = 128, 128
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    blur = (0.5 + 0.2 * np.sin(2 * np.pi * xx / 8)
            + 0.15 * np.sin(2 * np.pi * yy / 8))[..., None] \
        * np.ones(3) + rng.rand(h, w, 3) * 0.02
    blur[40:90, 50:110] = 0.55
    return blur, blur.copy(), np.zeros((h, w, 1))


@pytest.mark.parametrize('scene,options', [
    (_blob_scene, {}),                                   # autocal 'auto'
    (_blob_scene, {'seg_color_criterion': True}),
    (_blob_scene, {'seg_refine_protect': True, 'lpips_layers': 2}),
    (_band_scene, {'seg_refine_hysteresis': 0.5, 'lpips_thresh': 100.0,
                   'seg_autocal': 'off'}),
    (_band_scene, {'seg_autocal': 'on'}),
    (_plate_scene, {'seg_texture_criterion': True, 'seg_autocal': 'off'}),
])
def test_refinement_options_match_jax(alex, scene, options):
    """npp_tpu's refine_segmentation against the port's on the scenes of
    tests/test_segmentation.py under each gated option: the masks exactly,
    the L1 map rtol 1e-6 of its largest value (float64 on both sides) and
    every LPIPS map within the golden's 5e-4 of its largest value."""
    blur, pred, non_period = scene()
    data, jdata = _data(blur, non_period)
    cfg = TC.replace(TC.SegmentationConfig(), **options)
    jcfg = jax_replace(JaxSegConfig(), **options)
    got = refine_segmentation(cfg, data, pred, alex['t'])
    want = jax_refine(jcfg, jdata, pred, alex['j'])
    np.testing.assert_array_equal(got['non_period_mask'],
                                  want['non_period_mask'])
    np.testing.assert_array_equal(got['l1_mask'], want['l1_mask'])
    assert _scaled_err(got['l1_img'], want['l1_img']) <= 1e-6
    assert len(got['lpips_maps']) == len(want['lpips_maps'])
    for g, w, gm, wm in zip(got['lpips_maps'], want['lpips_maps'],
                            got['lpips_masks'], want['lpips_masks']):
        assert _scaled_err(g, w) <= 5e-4
        np.testing.assert_array_equal(gm, wm)


def test_segmentation_fit_step_matches_jax(monkeypatch):
    """One segmentation step (the blurred image as pixel source, period
    mask x valid as the sampler's mask; pixel and CX terms, no LPIPS) on
    the loader's data of a 48x64 synthetic example with patch 16, the
    same MLP, latents, bands, pixel indices and PatchBatch on both sides:
    loss and terms rtol 1e-4; gradients of the MLP and the pixel latents
    within 2e-3 of each tensor's largest magnitude (the CX softmax
    amplifies convolution reassociation), as for the completion's step."""
    tcfg = TC.replace(TC.SegmentationConfig(), **TINY)
    tdata = segmentation_data(synthetic_segment_data(0, 48, 64), tcfg, CPU)
    tdata.patch_size = 16
    fields = {k: getattr(tdata, k) for k in (
        'img', 'masked_img', 'mask', 'valid_mask', 'i_train', 'i_val',
        'selected_shifts', 'selected_angles', 'selected_periods',
        'patch_size', 'extra')}
    cfg = jax_replace(JaxSegConfig(), matmul_precision='float32', **TINY)
    jdata = JaxTaskData(**fields)
    comps = JP.build_components(cfg, jdata, JAX_SEG_TASK)
    state, _ = JT.init_fit_state(cfg, JAX_SEG_TASK, comps.model,
                                 comps.embedder, jax.random.PRNGKey(0),
                                 comps.percep, comps.style)
    consts = JP.make_fit_consts(cfg, JAX_SEG_TASK, jdata, 16)
    for i in range(100):
        batch = JS.sample_patches(jax.random.PRNGKey(i), consts.sampler, 1,
                                  16, 2, cfg.invalid_ratio)
        if float(np.asarray(batch.valid).sum()) == 2:
            break
    monkeypatch.setattr(JT, 'sample_patches', lambda *a, **k: batch)
    jloss_fn = JT.build_loss_fn(cfg, JAX_SEG_TASK, comps.model, comps.percep,
                                comps.contextual, comps.style, 1, 16)
    key = jax.random.PRNGKey(7)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, comps.embedder, consts, key), has_aux=True))(
        state.params)
    pix_idx = jax.random.randint(jax.random.split(key)[0], (cfg.N_rand,), 0,
                                 consts.pool_train_n)

    tcomps = TP.build_components(tcfg, tdata, CPU, SEGMENTATION_TASK)
    assert tcomps.percep is None and tcomps.style is None
    tstate = TT.init_fit_state(tcfg, tcomps.model, tcomps.percep, CPU)
    npy = jax.tree.map(np.asarray, state.params)
    conv = params_from_jax({
        'mlp': npy['mlp'], 'adaptive_pix': npy['adaptive_pix'],
        'embedder': {'freq_bands': np.asarray(comps.embedder.freq_bands)}})
    tstate.params.mlp.load_state_dict(conv['mlp'])
    tstate.params.adaptive_pix.load_state_dict(conv['adaptive_pix'])
    tcomps.embedder.freq_bands = conv['embedder']['freq_bands']
    tbatch = TSa.PatchBatch(*[torch.as_tensor(np.asarray(v)) for v in
                              batch[:-1]], int(batch.source))
    tbatch.fake_coords = tbatch.fake_coords.long()
    tconsts = TP.make_fit_consts(tcfg, tdata, 16, CPU, SEGMENTATION_TASK)
    np.testing.assert_array_equal(tconsts.pixel_img.numpy(),
                                  np.asarray(consts.pixel_img))
    tloss_fn = TT.build_loss_fn(
        tcfg, tcomps.percep, tcomps.contextual, 1, 16,
        inject=(torch.as_tensor(np.asarray(pix_idx)).long(), tbatch),
        task=SEGMENTATION_TASK)
    loss, metrics = tloss_fn(tstate.params, tcomps.embedder, tconsts, None)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    for k in ('pixel', 'contextual'):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    assert float(jm['contextual']) > 0 and 'perceptual' not in metrics
    for name, p in jg['mlp'].items():
        lin = getattr(tstate.params.mlp, name)
        for got, want in ((lin.weight.grad.numpy().T, p['kernel']),
                          (lin.bias.grad.numpy(), p['bias'])):
            assert _scaled_err(got, want) <= 2e-3, name
    for f in ('latent_alpha', 'latent_scale'):
        assert _scaled_err(getattr(tstate.params.adaptive_pix, f).grad,
                           getattr(jg['adaptive_pix'], f)) <= 2e-3, f


def test_run_segmentation_small_on_the_cpu():
    """run_segmentation(device='cpu') on a 64x80 synthetic example, depth
    2, width 32, 3 iterations with a refinement at 2: finite maps of the
    image's shape and a boolean-valued mask, the coarse mask in the data."""
    cfg = TC.replace(TC.SegmentationConfig(), netdepth=2, netwidth=32,
                     N_iters=3, i_testset=2, i_print=1, N_rand=256)
    result, results, data = run_segmentation(
        cfg, save=False, device='cpu', data=synthetic_segment_data(0, 64, 80))
    assert sorted(results) == [2] and len(result.history) == 2
    res = results[2]
    assert res['non_period_mask'].shape == (64, 80, 1)
    assert set(np.unique(res['non_period_mask'])) <= {0.0, 1.0}
    assert res['l1_img'].shape == (64, 80)
    assert all(np.all(np.isfinite(m)) and m.shape == (64, 80)
               for m in res['lpips_maps'] + [res['l1_img']])
    init = data.extra['non_period_mask']
    assert init.shape[:2] == data.img.shape[:2] and 0 < init.mean() < 1
    assert all(np.isfinite(h['loss']) for h in result.history)
