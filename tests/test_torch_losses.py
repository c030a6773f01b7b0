"""Port parity on the CPU for the losses: the robust loss and K4's plain
version, the analytic towers, CX and LPIPS-robust, values and gradients.
Inputs come from numpy seeds and go through `npp_tpu` and `npp_tpu_torch`;
towers run on 32x32 patches."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npp_tpu.losses import robust as JR
from npp_tpu.losses.contextual import ContextualLoss as JaxCX
from npp_tpu.losses.lpips import LPIPS as JaxLPIPS
from npp_tpu.losses.pixel import img2mse as jax_img2mse
from npp_tpu_torch.kernels.robust_rho import rho_rows_plain
from npp_tpu_torch.losses import robust as TR
from npp_tpu_torch.losses.contextual import ContextualLoss
from npp_tpu_torch.losses.lpips import LPIPS
from npp_tpu_torch.losses.pixel import img2mse
from npp_tpu_torch.utils.convert import latents_state_dict, params_from_jax
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), 'goldens', 'robust_loss.npz')
CPU = torch.device('cpu')


def native_conv():
    """oneDNN's f32 convolutions on the CPU lose up to 1% of the towers'
    small input gradients (measured against a float64 evaluation);
    PyTorch's own convolutions agree with it to 1e-9, as XLA's do. The
    port's towers run on them in these tests."""
    return torch.backends.mkldnn.flags(enabled=False)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def _latents(rng, c):
    """Latents moved off their zero init, as after some fit steps."""
    return JR.AdaptiveLossParams(
        latent_alpha=jnp.asarray(rng.randn(1, c).astype(np.float32)),
        latent_scale=jnp.asarray(rng.randn(1, c).astype(np.float32) - 1.0))


def _port_latents(jlat, c):
    p = TR.adaptive_init(c)
    p.load_state_dict(latents_state_dict(jax.tree.map(np.asarray, jlat)))
    return p


def test_robust_loss_matches_reference_goldens():
    """Tolerance of tests/test_robust_loss.py for the same goldens."""
    g = np.load(GOLDEN)
    x, a, s = _t(g['x']), _t(g['alpha']), _t(g['scale'])
    for got, key in ((TR.general_lossfun(x, a, s), 'general'),
                     (TR.log_base_partition_function(a), 'log_partition'),
                     (TR.nllfun(x, a, s), 'nll')):
        np.testing.assert_allclose(got.numpy(), g[key], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('c,weighted', [(3, False), (64, True)])
def test_k4_plain_rows_match_jax_nll(c, weighted):
    """rho_rows_plain (K4's plain version) + the per-channel constant equals
    the JAX element-wise NLL summed with channel weights; gradients in x
    and both latents too. f32 pow/log1p differ in the last ulp between the
    frameworks: rtol 1e-5 on values, 1e-4 on gradients. The latent_alpha
    gradient also carries the log-partition spline's f32 derivative, which
    both packages get wrong by up to 1.7e-4 against a float64 evaluation at
    these inputs: atol 5e-4 there."""
    rng = np.random.RandomState(c)
    x = rng.randn(97, c).astype(np.float32) * 0.3
    w = (rng.rand(c).astype(np.float32) if weighted
         else np.ones(c, np.float32))
    jlat = _latents(rng, c)
    g = rng.randn(97).astype(np.float32)   # upstream gradient of the rows

    def jf(xx, lat):
        rows = jnp.sum(JR.adaptive_lossfun(xx, lat) * w, axis=-1)
        return jnp.sum(rows * g), rows

    (_, jrows), (jgx, jglat) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jlat)
    p = _port_latents(jlat, c)
    xt = _t(x, grad=True)
    rows = TR.weighted_nll_rows(xt, p, _t(w))
    torch.sum(rows * _t(g)).backward()
    np.testing.assert_allclose(rows.detach().numpy(), np.asarray(jrows),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(p.latent_alpha.grad.numpy(),
                               np.asarray(jglat.latent_alpha), rtol=1e-4,
                               atol=5e-4)
    np.testing.assert_allclose(p.latent_scale.grad.numpy(),
                               np.asarray(jglat.latent_scale), rtol=1e-4,
                               atol=1e-6)
    # the plain rho alone is general_lossfun's otherwise branch
    alpha, scale = TR.adaptive_alpha(p)[0], TR.adaptive_scale(p)[0]
    want = jnp.sum(JR.general_lossfun(jnp.asarray(x),
                                      JR.adaptive_alpha(jlat),
                                      JR.adaptive_scale(jlat)) * w, -1)
    np.testing.assert_allclose(
        rho_rows_plain(_t(x), alpha, scale, _t(w)).detach().numpy(),
        np.asarray(want), rtol=1e-5, atol=1e-6)


def test_grouped_nll_rows_equal_per_layer():
    """weighted_nll_rows_group (the LPIPS-robust path: one K4 forward
    launch on the card) equals weighted_nll_rows layer by layer on the
    CPU, bit for bit, in values and in the x and latent gradients."""
    rng = np.random.RandomState(5)
    shapes = ((50, 64), (12, 128), (3, 512))
    xs = [rng.randn(m, c).astype(np.float32) * 0.3 for m, c in shapes]
    ws = [rng.rand(c).astype(np.float32) for _, c in shapes]
    gs = [_t(rng.randn(m)) for m, _ in shapes]
    jlats = [_latents(rng, c) for _, c in shapes]
    runs = []
    for grouped in (True, False):
        ps = [_port_latents(jl, c) for jl, (_, c) in zip(jlats, shapes)]
        xt = [_t(x, grad=True) for x in xs]
        if grouped:
            rows = TR.weighted_nll_rows_group(xt, ps, [_t(w) for w in ws])
        else:
            rows = [TR.weighted_nll_rows(x, p, _t(w))
                    for x, p, w in zip(xt, ps, ws)]
        torch.autograd.backward(rows, gs)
        runs.append([r.detach() for r in rows] + [x.grad for x in xt] +
                    [q.grad for p in ps for q in p.parameters()])
    for got, want in zip(*runs):
        assert torch.equal(got, want)


@pytest.mark.parametrize('loss_type', ['robust_loss_adaptive', 'robust_loss',
                                       'l2'])
def test_img2mse_matches_jax(loss_type):
    """Masked pixel loss, value and prediction gradient (rtol as above)."""
    rng = np.random.RandomState(7)
    pred = rng.rand(64, 3).astype(np.float32)
    gt = rng.rand(64, 3).astype(np.float32)
    mask = (rng.rand(64, 1) > 0.3).astype(np.float32)
    jlat = _latents(rng, 3)
    jv, jg = jax.value_and_grad(lambda p: jax_img2mse(
        p, jnp.asarray(gt), loss_type, jlat, jnp.asarray(mask)))(
        jnp.asarray(pred))
    pt = _t(pred, grad=True)
    v = img2mse(pt, _t(gt), loss_type, _port_latents(jlat, 3), _t(mask))
    v.backward()
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-5)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-7)


@pytest.fixture(scope='module')
def towers():
    """Both packages' CX and LPIPS, built once for the module (the analytic
    tower generation is the slow part)."""
    return {'jcx': JaxCX(use_vgg=True), 'jlp': JaxLPIPS(net='vgg'),
            'cx': ContextualLoss(CPU), 'lp': LPIPS(CPU, net='vgg')}


def test_analytic_towers_equal_jax_exactly(towers):
    """Seeds follow the lexical order of all flax conv names (conv10 before
    conv2, counter from 1): bitwise-equal kernels after HWIO -> OIHW
    (params_from_jax's conversion)."""
    for jparams, port, n in ((towers['jcx'].params, towers['cx'].tower, 8),
                             (towers['jlp'].params, towers['lp'].tower, 13)):
        assert len(port.params) == n
        convs = params_from_jax({'convs': {
            f'conv{i}': np.asarray(jparams[f'conv{i}']['kernel'])
            for i in range(n)}})['convs']
        for i in range(n):
            w, b = port.params[f'conv{i}']
            np.testing.assert_array_equal(w.numpy(), convs[f'conv{i}'].numpy())
            np.testing.assert_array_equal(b.numpy(),
                                          np.asarray(jparams[f'conv{i}']['bias']))


def _patches(seed, n=3, s=32):
    rng = np.random.RandomState(seed)
    a = rng.rand(n, s, s, 3).astype(np.float32)
    b = np.clip(a + rng.randn(n, s, s, 3).astype(np.float32) * 0.2, 0, 1)
    return a, b


def test_contextual_value_and_grad_match_jax(towers):
    """VGG19-relu3_4 CX with a valid mask. Convolutions reassociate
    differently in XLA and PyTorch and the relative-distance softmax (band
    width 0.5) amplifies that: rtol 1e-4 on the value, 2e-3 on the
    gradient."""
    a, b = _patches(0)
    valid = np.array([True, False, True])
    jv, jg = jax.jit(jax.value_and_grad(lambda x: towers['jcx'](
        x, jnp.asarray(b), valid=jnp.asarray(valid))))(jnp.asarray(a))
    at = _t(a, grad=True)
    with native_conv():
        v = towers['cx'](at, _t(b), valid=torch.as_tensor(valid))
        v.backward()
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-4)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(jg), rtol=2e-3,
                               atol=2e-6)


def test_lpips_robust_value_and_grads_match_jax(towers):
    """VGG16 LPIPS with per-layer adaptive robust diffs (K4's plain version
    on the CPU): value, input gradient and every latent's gradient. Same
    tolerance reasoning as CX, without the softmax: rtol 1e-4 / 1e-3; atol
    2e-5 on latent_alpha for the log-partition spline's f32 derivative (see
    test_k4_plain_rows_match_jax_nll)."""
    a, b = _patches(1)
    rng = np.random.RandomState(2)
    jlats = tuple(_latents(rng, c) for c in (64, 128, 256, 512, 512))

    def jf(x, lats):
        return jnp.mean(towers['jlp'](x, jnp.asarray(b), use_robust=True,
                                      adaptive=lats, normalize=True))

    jv, (jgx, jglat) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(
        jnp.asarray(a), jlats)
    lats = towers['lp'].init_adaptive()
    for p, jl in zip(lats, jlats):
        p.load_state_dict(latents_state_dict(jax.tree.map(np.asarray, jl)))
    at = _t(a, grad=True)
    with native_conv():
        v = torch.mean(towers['lp'](at, _t(b), use_robust=True,
                                    adaptive=lats, normalize=True))
        v.backward()
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-4)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(jgx), rtol=1e-3,
                               atol=1e-6)
    for p, jl in zip(lats, jglat):
        np.testing.assert_allclose(p.latent_alpha.grad.numpy(),
                                   np.asarray(jl.latent_alpha), rtol=1e-3,
                                   atol=2e-5)
        np.testing.assert_allclose(p.latent_scale.grad.numpy(),
                                   np.asarray(jl.latent_scale), rtol=1e-3,
                                   atol=1e-6)
    # the plain metric (val_lpips) agrees as well
    jm = jax.jit(lambda x, y: towers['jlp'](x, y, normalize=True))(
        jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad(), native_conv():
        m = towers['lp'](_t(a), _t(b), normalize=True)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-4)


def _lpips_f64(lp):
    """A float64 copy of a port LPIPS: its tower, heads, shift and scale
    cast (the cached f32 tower is left as it is)."""
    import copy
    out = copy.copy(lp)
    out.tower = copy.copy(lp.tower)
    out.tower.params = {k: (w.double(), b.double())
                        for k, (w, b) in lp.tower.params.items()}
    out.tower.dtype = torch.float64
    out.lins = [x.double() for x in lp.lins]
    out.shift, out.scale = lp.shift.double(), lp.scale.double()
    return out


@pytest.mark.parametrize('net,robust', [('vgg', False), ('vgg', True),
                                        ('alex', False)])
def test_lpips_f32_input_gradient_tracks_float64(towers, net, robust):
    """The port's f32 LPIPS input gradient against the same module in
    float64, on tests' default CPU convolutions (no native_conv): within
    5e-5 of the largest float64 magnitude, about ten times JAX's own f32
    distance from it at these inputs (scripts/lpips_grad_vs_float64.py
    prints both). The towers used to run on permuted NHWC input, which
    PyTorch's CPU convolutions accumulate less accurately: a ReLU flipped
    on that error and put the gradient about 1e-2 from float64
    (nn/features.py::cpu_nchw)."""
    a, b = _patches(1) if net == 'vgg' else _patches(1, n=2, s=64)
    lp = towers['lp'] if net == 'vgg' else LPIPS(CPU, net='alex')
    lats = lp.init_adaptive()
    rng = np.random.RandomState(2)
    with torch.no_grad():
        for p in lats:
            p.latent_alpha.copy_(torch.tensor(rng.randn(*p.latent_alpha.shape)))
            p.latent_scale.copy_(torch.tensor(rng.randn(
                *p.latent_scale.shape) - 1.0))
    grads = []
    for mod, dt in ((lp, torch.float32), (_lpips_f64(lp), torch.float64)):
        x = torch.tensor(a, dtype=dt, requires_grad=True)
        v = torch.mean(mod(x, torch.tensor(b, dtype=dt), use_robust=robust,
                           adaptive=lats.to(dt) if robust else None,
                           normalize=True))
        v.backward()
        grads.append(x.grad.double().numpy())
    g32, g64 = grads
    assert np.abs(g32 - g64).max() <= 5e-5 * np.abs(g64).max()
