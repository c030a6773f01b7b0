"""Port parity on the CPU for the remapping task: the blur map and the
masked blur, the style loss (plain and adaptive, values and gradients), K4's
plain version at the style loss's shapes, one remapping step on an injected
batch, a small run_remapping against `npp_tpu`'s, the collapse guard and
`cli remap`. The same numpy inputs, made from a seed, go through both
packages; each test states its tolerance."""
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npp_tpu.config import RemappingConfig as JaxRemappingConfig
from npp_tpu.config import replace as jax_replace
from npp_tpu.losses import robust as JR
from npp_tpu.losses.style import StyleLoss as JaxStyleLoss
from npp_tpu.models import pipeline as JP
from npp_tpu.models import sampler as JS
from npp_tpu.models import trainer as JT
from npp_tpu.models.loaders import TaskData as JaxTaskData
from npp_tpu.models.remapping import REMAPPING_TASK as JAX_REMAPPING_TASK
from npp_tpu.ops import blur as JB
from npp_tpu_torch import config as TC
from npp_tpu_torch.losses.robust import adaptive_init, weighted_nll_rows
from npp_tpu_torch.losses.style import StyleLoss
from npp_tpu_torch.models import pipeline as TP
from npp_tpu_torch.models import remapping as TR
from npp_tpu_torch.models import sampler as TS
from npp_tpu_torch.models import trainer as TT
from npp_tpu_torch.models.loaders import TaskData
from npp_tpu_torch.ops import blur as TB
from npp_tpu_torch.utils.convert import latents_state_dict, params_from_jax
from npp_tpu_torch.utils.synthetic import synthetic_remap_data
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

CPU = torch.device('cpu')


def _assert_scaled(got, want, rtol, what):
    """|got - want| <= rtol * max|want| over the whole tensor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (what, err,
                                                          np.abs(want).max())


def _degree_f64(img_u8):
    """The normalised degree map in float64 (the Grams of integer grays are
    exact there): the truth both f32 maps are held to."""
    gray = TB.rgb2gray(img_u8).astype(np.float64)
    h, w = gray.shape
    win = np.lib.stride_tricks.sliding_window_view(
        TB._reference_pad(gray, 10), (20, 20))[:h, :w].reshape(-1, 20, 20)
    s = np.sqrt(np.maximum(np.linalg.eigvalsh(
        np.einsum('nij,nik->njk', win, win)), 0.0))
    d = (s[:, -3:].sum(1) / (s.sum(1) + 1e-6)).reshape(h, w)
    return (d - d.min()) / (d.max() - d.min())


def test_blur_map_matches_jax():
    """96x128 synthetic remapping image (blurred inside an ellipse). The
    degree map: a window's Gram of raw 0-255 grays is near singular (its
    smallest float64 eigenvalue is about 1e-9 of the largest, which is 6e5)
    and f32 rounds its trailing eigenvalues to noise of order eps times the
    largest, in JAX as in the port; the noise's square roots move the
    normalised degree by about 5e-3 from the float64 truth in both. So the
    port's map is held to the float64 map, no further than twice JAX's own
    distance from it (and 1e-2 from JAX's). The clear masks are equal
    here; the host half (threshold and morphology) alone must give JAX's
    mask from JAX's degree map."""
    img = np.uint8(synthetic_remap_data(0, 96, 128)['gt_img'] * 255)
    jdeg, jmask = JB.blur_map(img)
    tdeg, tmask = TB.blur_map(img, device=CPU)
    assert tdeg.shape == jdeg.shape == (96, 128) and tdeg.dtype == jdeg.dtype
    truth = _degree_f64(img)
    jax_err = np.abs(jdeg - truth).max()
    assert np.abs(tdeg - truth).max() <= 2 * jax_err, jax_err
    np.testing.assert_allclose(tdeg, jdeg, rtol=0, atol=1e-2)
    # the host half alone, on JAX's (already normalised) degree map
    _, host_mask = TB.clear_mask_from_degree(jdeg)
    np.testing.assert_array_equal(host_mask, jmask)
    np.testing.assert_array_equal(tmask, jmask)
    assert 0 < (tmask > 0).mean() < 1


def test_blur_with_mask_matches_jax():
    rng = np.random.RandomState(1)
    img = rng.rand(30, 34, 3) * 255
    mask = (rng.rand(30, 34, 1) > 0.3).astype(np.float64)
    np.testing.assert_allclose(TB.blur_with_mask(img, mask, 2.0),
                               JB.blur_with_mask(img, mask, 2.0),
                               rtol=1e-12, atol=1e-9)


def _style_inputs(seed=0, n=6, s=32):
    rng = np.random.RandomState(seed)
    a = rng.rand(n, s, s, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(n, s, s, 3), 0, 1).astype(np.float32)
    lats = [(0.5 * rng.randn(1, c * c).astype(np.float32),
             0.5 * rng.randn(1, c * c).astype(np.float32))
            for c in (64, 128, 256)]
    weight = rng.rand(n).astype(np.float32)
    valid = (rng.rand(n) > 0.3)
    valid[0] = True
    return a, b, lats, weight, valid


@functools.lru_cache(maxsize=None)
def _jax_style(adaptive):
    """JAX's style loss and its gradients in the first image and the
    latents on _style_inputs(), for both aggregations ('valid', 'weight'),
    from one jitted function."""
    a, b, lats, weight, valid = _style_inputs()
    jstyle = JaxStyleLoss(use_adaptive=adaptive)
    jlat = tuple(JR.AdaptiveLossParams(jnp.asarray(la), jnp.asarray(ls))
                 for la, ls in lats)

    def both(a_img, lat):
        return {agg: jax.value_and_grad(
            lambda x, l_: jstyle(x, jnp.asarray(b), weight=w,
                                 adaptive=l_ if adaptive else None,
                                 valid=jnp.asarray(valid)),
            argnums=(0, 1))(a_img, lat)
            for agg, w in (('valid', None), ('weight', jnp.asarray(weight)))}
    return jstyle, jax.jit(both)(jnp.asarray(a), jlat)


@pytest.mark.parametrize('adaptive', [False, True])
@pytest.mark.parametrize('agg', ['valid', 'weight'])
def test_style_loss_matches_jax(adaptive, agg):
    """Six 32x32 patches (pool3 at 4x4), latents away from 0 (alpha != 1),
    on the shared analytic VGG16 weights, aggregated over the valid
    patches or with weights: the value within rtol 1e-4, the gradients in
    the first image and in the three layers' latents within 1e-3 of each
    tensor's largest magnitude (f32 convolutions and Grams summed in
    another order)."""
    a, b, lats, weight, valid = _style_inputs()
    jstyle, res = _jax_style(adaptive)
    jl, (jga, jglat) = res[agg]

    style = StyleLoss(CPU, use_adaptive=adaptive)
    w0 = style.tower.params['conv0'][0].numpy().transpose(2, 3, 1, 0)
    np.testing.assert_array_equal(
        w0, np.asarray(jstyle.params['conv0']['kernel']))
    tlat = style.init_adaptive()
    for p, lat in zip(tlat, lats):
        p.load_state_dict(latents_state_dict(lat))
    ta = torch.tensor(a, requires_grad=True)
    with torch.backends.mkldnn.flags(enabled=False):
        tl = style(ta, torch.tensor(b),
                   weight=torch.tensor(weight) if agg == 'weight' else None,
                   adaptive=tlat if adaptive else None,
                   valid=torch.tensor(valid))
        tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    _assert_scaled(ta.grad.numpy(), jga, 1e-3, 'image')
    if adaptive:
        for p, g in zip(tlat, jglat):
            _assert_scaled(p.latent_alpha.grad.numpy(), g.latent_alpha, 1e-3,
                           'latent_alpha')
            _assert_scaled(p.latent_scale.grad.numpy(), g.latent_scale, 1e-3,
                           'latent_scale')


def test_k4_plain_at_the_style_shape_matches_jax_nllfun():
    """(6, 4096), the first style layer's flattened Gram residual, with
    alpha and scale per column from random latents: the port's
    weighted_nll_rows (on the CPU, K4's plain version plus the per-channel
    constant) against JAX's adaptive nll summed with the same weights,
    values and gradients in x and the latents within rtol 1e-5 of the
    largest."""
    rng = np.random.RandomState(2)
    m, c = 6, 4096
    x = (rng.randn(m, c) * 3.0).astype(np.float32)
    la, ls = (rng.randn(1, c).astype(np.float32) for _ in range(2))
    wv = (rng.rand(c) / c).astype(np.float32)

    def jfn(x_, lat):
        return jnp.sum(JR.adaptive_lossfun(x_, lat) * wv, -1)
    jlat = JR.AdaptiveLossParams(jnp.asarray(la), jnp.asarray(ls))
    jr, (gx, glat) = jax.jit(jax.value_and_grad(
        lambda x_, lat: jnp.sum(jfn(x_, lat) * jnp.arange(1.0, m + 1)),
        argnums=(0, 1)))(jnp.asarray(x), jlat)
    jr = jfn(jnp.asarray(x), jlat)

    p = adaptive_init(c)
    p.load_state_dict(latents_state_dict((la, ls)))
    tx = torch.tensor(x, requires_grad=True)
    tr = weighted_nll_rows(tx, p, torch.tensor(wv))
    torch.sum(tr * torch.arange(1.0, m + 1)).backward()
    _assert_scaled(tr.detach().numpy(), jr, 1e-5, 'rows')
    _assert_scaled(tx.grad.numpy(), gx, 1e-5, 'x')
    _assert_scaled(p.latent_alpha.grad.numpy(), glat.latent_alpha, 1e-5,
                   'latent_alpha')
    _assert_scaled(p.latent_scale.grad.numpy(), glat.latent_scale, 1e-5,
                   'latent_scale')


TINY = dict(netwidth=32, netdepth=6, N_rand=64, patch_num=1,
            num_real_patch_per_sample=2)


def _remap_arrays(h=40, w=48):
    """tests/test_trainer.py's tiny lattice, sharp, with a clear mask that
    is 0 on a band (as a blur map would give) instead of a blur map."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    img = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * yy / 10.0),
                    0.5 + 0.4 * np.cos(2 * np.pi * xx / 12.0),
                    0.5 + 0.2 * np.sin(2 * np.pi * (yy / 10.0 + xx / 12.0))],
                   -1)
    clear = np.ones((h, w, 1))
    clear[:, 30:38] = 0
    valid = np.ones((h, w, 1))
    return dict(img=img, masked_img=img, mask=clear, valid_mask=valid,
                i_train=np.stack(np.nonzero(valid[..., 0]), 1),
                i_val=np.stack(np.nonzero(clear[..., 0]), 1),
                selected_shifts=[[[12.0, 0.0], [0.0, 10.0]]] * 3,
                selected_angles=[[90.0, 180.0]] * 3,
                selected_periods=[[10.0, 12.0]] * 3, patch_size=16,
                extra={'clear_mask': clear})


def test_remap_step_matches_jax(monkeypatch):
    """One remapping step with the pixel (clear-mask weighted), CX and
    adaptive style terms on, the same MLP, latents, bands, pixel indices and
    PatchBatch on both sides (the JAX sampler patched to return it, the
    port's injected), f32: loss and terms rtol 1e-4; gradients of the MLP
    and of the pixel and style latents within 2e-3 of each tensor's
    largest magnitude (the CX softmax amplifies convolution
    reassociation)."""
    cfg = jax_replace(JaxRemappingConfig(), matmul_precision='float32',
                      **TINY)
    arrays = _remap_arrays()
    jdata = JaxTaskData(**arrays)
    comps = JP.build_components(cfg, jdata, JAX_REMAPPING_TASK)
    state, _ = JT.init_fit_state(cfg, JAX_REMAPPING_TASK, comps.model,
                                 comps.embedder, jax.random.PRNGKey(0),
                                 comps.percep, comps.style)
    # latents away from their init, so that alpha != 1 in every layer
    rng = np.random.RandomState(3)
    params = dict(state.params)
    params['adaptive_style'] = tuple(JR.AdaptiveLossParams(
        jnp.asarray(0.5 * rng.randn(*p.latent_alpha.shape), jnp.float32),
        jnp.asarray(0.5 * rng.randn(*p.latent_scale.shape), jnp.float32))
        for p in state.params['adaptive_style'])
    consts = JP.make_fit_consts(cfg, JAX_REMAPPING_TASK, jdata, 16)
    for i in range(100):
        batch = JS.sample_patches(jax.random.PRNGKey(i), consts.sampler, 1,
                                  16, 2, cfg.invalid_ratio)
        if int(batch.source) == JS.SOURCE_VAL and \
                float(np.asarray(batch.valid).sum()) == 2:
            break
    monkeypatch.setattr(JT, 'sample_patches', lambda *a, **k: batch)
    jloss_fn = JT.build_loss_fn(cfg, JAX_REMAPPING_TASK, comps.model,
                                comps.percep, comps.contextual, comps.style,
                                1, 16)
    key = jax.random.PRNGKey(7)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, comps.embedder, consts, key), has_aux=True))(
        params)
    pix_idx = jax.random.randint(jax.random.split(key)[0], (cfg.N_rand,), 0,
                                 consts.pool_train_n)

    tcfg = TC.replace(TC.RemappingConfig(), **TINY)
    tdata = TaskData(**arrays)
    task = TR.REMAPPING_TASK
    tcomps = TP.build_components(tcfg, tdata, CPU, task)
    assert tcomps.style is not None and tcomps.percep is None
    tstate = TT.init_fit_state(tcfg, tcomps.model, tcomps.percep, CPU,
                               tcomps.style)
    npy = jax.tree.map(np.asarray, params)
    conv = params_from_jax({
        'mlp': npy['mlp'], 'adaptive_pix': npy['adaptive_pix'],
        'adaptive_style': npy['adaptive_style'],
        'embedder': {'freq_bands': np.asarray(comps.embedder.freq_bands)}})
    tstate.params.mlp.load_state_dict(conv['mlp'])
    tstate.params.adaptive_pix.load_state_dict(conv['adaptive_pix'])
    tstate.params.adaptive_style.load_state_dict(conv['adaptive_style'])
    tcomps.embedder.freq_bands = conv['embedder']['freq_bands']
    tbatch = TS.PatchBatch(*[torch.as_tensor(np.asarray(v)) for v in
                             batch[:-1]], int(batch.source))
    tbatch.fake_coords = tbatch.fake_coords.long()
    tloss_fn = TT.build_loss_fn(
        tcfg, tcomps.percep, tcomps.contextual, 1, 16,
        inject=(torch.as_tensor(np.asarray(pix_idx)).long(), tbatch),
        style=tcomps.style, task=task)
    with torch.backends.mkldnn.flags(enabled=False):
        loss, metrics = tloss_fn(tstate.params, tcomps.embedder,
                                 TP.make_fit_consts(tcfg, tdata, 16, CPU,
                                                    task), None)
        loss.backward()

    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    for k in ('pixel', 'contextual', 'style'):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    assert float(jm['style']) > 0 and 'perceptual' not in metrics
    for name, p in jg['mlp'].items():
        lin = getattr(tstate.params.mlp, name)
        _assert_scaled(lin.weight.grad.numpy().T, p['kernel'], 2e-3, name)
        _assert_scaled(lin.bias.grad.numpy(), p['bias'], 2e-3, name)
    pairs = [(tstate.params.adaptive_pix, jg['adaptive_pix'])]
    pairs += list(zip(tstate.params.adaptive_style, jg['adaptive_style']))
    for tp, jp in pairs:
        for f in ('latent_alpha', 'latent_scale'):
            _assert_scaled(getattr(tp, f).grad, getattr(jp, f), 2e-3, f)


@pytest.fixture()
def remap_dir(tmp_path):
    """A remapping example directory: the 64x80 synthetic image blurred
    inside an ellipse, its valid mask and a record with its lattices."""
    import cv2
    arr = synthetic_remap_data(0, 64, 80)
    d = tmp_path / 'remap_ex'
    os.makedirs(d)
    cv2.imwrite(str(d / 'gt_img.png'), np.uint8(arr['gt_img'][..., ::-1] * 255))
    cv2.imwrite(str(d / 'valid_mask.png'),
                np.uint8(arr['valid_mask'][..., 0] * 255))
    odgt = {'fpath_gt_img': 'gt_img.png', 'fpath_valid_mask': 'valid_mask.png',
            **{k: arr[k] for k in ('selected_shifts', 'selected_angles',
                                   'selected_periods')}}
    with open(d / 'config.odgt', 'w') as f:
        json.dump(odgt, f)
        f.write('\n')
    return str(d)


BUDGET = dict(netwidth=32, netdepth=4, N_rand=256, patch_num=1,
              num_real_patch_per_sample=2, N_iters=21, i_testset=10,
              i_print=10, use_contextual_loss=False)
MARGIN_DB = 2.0


def test_run_remapping_tracks_jax(remap_dir, tmp_path):
    """Both packages' run_remapping on the same example directory at the
    same budget (adaptive style loss on, CX off to keep the JAX compile
    short; the step test holds CX): the loader's clear mask equal, the
    final train and clear-region PSNR within 2 dB (the packages draw
    different bands, inits and batches: PARITY.md deviation 1), finite
    LPIPS, and no kernel launched on the CPU."""
    from npp_tpu.models.remapping import run_remapping as jax_run
    from npp_tpu_torch.kernels import launch_counts, reset_launches
    _, jfinal, _ = jax_run(jax_replace(
        JaxRemappingConfig(), datadir=remap_dir,
        basedir=str(tmp_path / 'jax'), **BUDGET), save=False)
    reset_launches()
    cfg = TC.replace(TC.RemappingConfig(), datadir=remap_dir,
                     basedir=str(tmp_path / 'port'), **BUDGET)
    result, final, evals = TR.run_remapping(cfg, save=True, device='cpu')
    assert sorted(evals) == [10, 20] and len(result.history) == 2
    assert all(np.isfinite(h['style']) for h in result.history)
    for k in ('train_psnr', 'val_psnr'):
        assert abs(final[k] - jfinal[k]) < MARGIN_DB, (k, final[k], jfinal[k])
    for k in ('full_lpips', 'clear_lpips'):
        assert np.isfinite(final[k]) and k in jfinal
    assert 'collapse_guard_iter' not in final
    assert not any(launch_counts().values())
    out = os.path.join(str(tmp_path / 'port'), 'remapping_top3', 'remap_ex')
    for f in ('blur_mask.png', 'testset_000020/pred_rgb_img.png'):
        assert os.path.exists(os.path.join(out, f)), f
    from npp_tpu.models.loaders import load_remapping as jax_load
    from npp_tpu_torch.models.loaders import load_remapping
    np.testing.assert_array_equal(load_remapping(cfg, CPU).mask,
                                  jax_load(cfg).mask)


class _FakeParams(torch.nn.Module):
    """Stands in for FitParams: the 'psnr' its evaluation reports."""

    def __init__(self, psnr):
        super().__init__()
        self.register_buffer('psnr', torch.tensor(float(psnr)))
        self.adaptive_pix = None


def test_remap_collapse_guard_returns_best_milestone(monkeypatch):
    """tests/test_trainer.py::test_remap_collapse_guard_returns_best_
    milestone on the port: a final eval more than remap_guard_db below the
    best milestone returns the best milestone's outputs (restored from the
    host copy of its parameters) with collapse_guard_iter; a healthy final
    is untouched; with the guard off the collapsed final is returned."""
    def fake_evaluate(data, params, render, adaptive, loss_type, device,
                      percep=None):
        return {'train_psnr': float(params.psnr),
                'val_psnr': float(params.psnr),
                'pred_rgb_img': np.zeros((4, 4, 3))}

    trajectory = {'collapse': [(400, 20.0), (800, 30.0), (1200, 5.0)],
                  'healthy': [(400, 20.0), (800, 30.0), (1200, 31.0)]}

    def make_fit(traj):
        def fake_fit(cfg, data, eval_hook=None, log_every=None, device=None,
                     task=None):
            params = _FakeParams(0.0)
            st = types.SimpleNamespace(params=params)
            for it, psnr in traj:
                params.psnr.fill_(psnr)
                eval_hook(it, st, None)
            return types.SimpleNamespace(state=st, render=None)
        return fake_fit

    monkeypatch.setattr(TR, 'remapping_data', lambda arrays, cfg, device:
                        types.SimpleNamespace(orig_shape=(4, 4)))
    monkeypatch.setattr(TR, 'evaluate', fake_evaluate)
    monkeypatch.setattr(TR, 'LPIPS', lambda *a, **k: None)
    cfg = TC.replace(TC.RemappingConfig(), datadir='x', basedir='y')

    def run(traj, cfg_=cfg):
        monkeypatch.setattr(TR, 'fit_image', make_fit(trajectory[traj]))
        return TR.run_remapping(cfg_, save=False, device='cpu', data={})[1]

    final = run('collapse')
    assert final['train_psnr'] == 30.0          # best milestone restored
    assert final['collapse_guard_iter'] == 800.0
    final = run('healthy')
    assert final['train_psnr'] == 31.0          # untouched
    assert 'collapse_guard_iter' not in final
    final = run('collapse', TC.replace(cfg, remap_guard=False))
    assert final['train_psnr'] == 5.0


def test_cli_remap_runs_on_the_cpu(remap_dir, tmp_path, capsys):
    from npp_tpu_torch.cli import main
    assert main(['remap', '--datadir', remap_dir, '--basedir', str(tmp_path),
                 '--device', 'cpu', '--netwidth', '16', '--netdepth', '2',
                 '--N_rand', '64', '--patch_num', '1',
                 '--num_real_patch_per_sample', '2', '--N_iters', '3',
                 '--i_testset', '2', '--i_print', '2']) == 0
    out = capsys.readouterr().out
    assert 'clear_lpips' in out and 'train_psnr' in out
    assert os.path.exists(os.path.join(str(tmp_path), 'remapping_top3',
                                       'remap_ex', 'blur_mask.png'))
