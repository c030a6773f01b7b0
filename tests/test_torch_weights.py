"""The port's weight sources and LPIPS-squeeze on the CPU against
`npp_tpu`'s: each source (asset, $NPP_TPU_WEIGHTS_DIR npz,
$NPP_TPU_TORCH_WEIGHTS .pth, analytic, NPP_TPU_FALLBACK=random) gives the
same WeightReport in both packages under the same environment, the first
three the same LPIPS value; the random fallback's kernels have flax's
spread; SqueezeNet's analytic weights equal npp_tpu's and its LPIPS (plain,
spatial, robust) matches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import npp_tpu.nn.pretrained as JP
import npp_tpu_torch.nn.pretrained as TP
from npp_tpu.losses.lpips import LPIPS as JaxLPIPS
from npp_tpu.nn.features import AlexNetFeatures as JaxAlex
from npp_tpu_torch.losses.lpips import LPIPS
from npp_tpu_torch.nn.features import ALEX_CONV_SHAPES, squeeze_conv_shapes
from npp_tpu_torch.utils.convert import latents_state_dict
from npp_tpu_torch.utils.torch_convert import convert_state_dict
from tests.test_torch_losses import _latents, _patches, _t, native_conv
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

CPU = torch.device('cpu')
ENV = ('NPP_TPU_FALLBACK', 'NPP_TPU_WEIGHTS_DIR', 'NPP_TPU_TORCH_WEIGHTS')
ALEX_FEATURES = (0, 3, 6, 8, 10)   # torchvision alexnet's conv indices


@pytest.fixture
def fresh(monkeypatch):
    """Both packages' tower caches and reports emptied, the three
    environment variables unset; restored after the test."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(JP, '_PARAM_CACHE', {})
    monkeypatch.setattr(JP, '_REPORTS', {})
    monkeypatch.setattr(TP, '_TOWERS', {})
    monkeypatch.setattr(TP, '_REPORTS', {})
    return monkeypatch


def _alex_state(seed=0):
    """A torchvision-keyed AlexNet state_dict (OIHW), small random
    weights, plus a classifier entry the converter must skip."""
    rng = np.random.RandomState(seed)
    state = {}
    for i, (kh, kw, cin, cout) in zip(ALEX_FEATURES,
                                      ALEX_CONV_SHAPES.values()):
        std = 1.0 / np.sqrt(kh * kw * cin)
        state[f'features.{i}.weight'] = torch.tensor(
            (rng.randn(cout, cin, kh, kw) * std).astype(np.float32))
        state[f'features.{i}.bias'] = torch.tensor(
            (rng.randn(cout) * 0.1).astype(np.float32))
    state['classifier.1.weight'] = torch.zeros(4, 9216)
    return state


def _npz_of(state, path):
    """The same weights as a flat HWIO npz ('conv<n>/kernel')."""
    flat = {}
    for n, i in enumerate(ALEX_FEATURES):
        flat[f'conv{n}/kernel'] = state[f'features.{i}.weight'].numpy(
        ).transpose(2, 3, 1, 0)
        flat[f'conv{n}/bias'] = state[f'features.{i}.bias'].numpy()
    np.savez(path, **flat)


def _lpips_alex_values():
    """LPIPS-alex of both packages on the same pair, and the towers'
    reports."""
    a, b = _patches(0, n=2, s=48)
    jv = np.asarray(JaxLPIPS(net='alex')(jnp.asarray(a), jnp.asarray(b),
                                         normalize=True))
    with torch.no_grad(), native_conv():
        tv = LPIPS(CPU, net='alex')(_t(a), _t(b), normalize=True).numpy()
    return tv, jv


def _reports(name):
    return TP.weight_reports()[name].source, JP.weight_reports()[name].source


@pytest.mark.parametrize('source', ['torch', 'weights_dir', 'asset'])
def test_converted_sources_match_jax(fresh, tmp_path, source):
    """The same AlexNet weights as a .pth (npp_tpu converts it through its
    own convert_state_dict), as an npz in the weights directory, and as an
    asset: the same report in both packages, pretrained, and the same
    LPIPS value (rtol 1e-5). A .pth and an npz side by side: the npz wins,
    as in npp_tpu."""
    state = _alex_state()
    if source == 'torch':
        torch.save(state, str(tmp_path / 'alexnet_tv.pth'))
        fresh.setenv('NPP_TPU_TORCH_WEIGHTS', str(tmp_path))
    elif source == 'weights_dir':
        _npz_of(state, str(tmp_path / 'alexnet_tv.npz'))
        torch.save(_alex_state(1), str(tmp_path / 'alexnet_tv.pth'))
        fresh.setenv('NPP_TPU_WEIGHTS_DIR', str(tmp_path))
        fresh.setenv('NPP_TPU_TORCH_WEIGHTS', str(tmp_path))
    else:
        _npz_of(state, str(tmp_path / 'alexnet_tv.npz'))
        # the LPIPS heads come from the real assets either way
        for net in ('alex',):
            src = TP._find_npz(f'lpips_lin_{net}')
            (tmp_path / f'lpips_lin_{net}.npz').write_bytes(
                open(src, 'rb').read())
        fresh.setattr(JP, 'ASSET_DIR', str(tmp_path))
        fresh.setattr(TP, 'ASSET_DIR', str(tmp_path))
    tv, jv = _lpips_alex_values()
    assert _reports('alexnet_tv') == (source, source)
    assert TP.weight_reports()['alexnet_tv'].pretrained
    assert _reports('lpips_lin_alex') == ('asset', 'asset')
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    # the weights are the checkpoint's, in OIHW
    w0, _ = TP.load_tower_params('alexnet_tv', ALEX_CONV_SHAPES, 5, CPU)[
        'conv0']
    np.testing.assert_array_equal(w0.numpy(),
                                  state['features.0.weight'].numpy())


def test_pth_conversion_keys_match_jax(tmp_path):
    """The port's .pth mapping equals npp_tpu's after HWIO -> OIHW, for
    the sequential towers and SqueezeNet's fires."""
    from npp_tpu.utils.torch_convert import convert_state_dict as jconv
    state = _alex_state()
    torch.save(state, str(tmp_path / 'a.pth'))
    got = convert_state_dict('alexnet_tv', str(tmp_path / 'a.pth'))
    want = jconv('alexnet_tv', str(tmp_path / 'a.pth'))
    assert sorted(got) == [f'conv{n}' for n in range(5)]
    for k, (w, b) in got.items():
        np.testing.assert_array_equal(w, want[f'{k}/kernel'].transpose(
            3, 2, 0, 1))
        np.testing.assert_array_equal(b, want[f'{k}/bias'])
    rng = np.random.RandomState(1)
    sq = {'features.0.weight': torch.tensor(rng.randn(64, 3, 3, 3)),
          'features.0.bias': torch.tensor(rng.randn(64))}
    for path, (kh, kw, cin, cout) in squeeze_conv_shapes().items():
        if path == 'conv0':
            continue
        i, part = path[4:].split('/')
        sq[f'features.{i}.{part}.weight'] = torch.tensor(
            rng.randn(cout, cin, kh, kw))
        sq[f'features.{i}.{part}.bias'] = torch.tensor(rng.randn(cout))
    torch.save(sq, str(tmp_path / 's.pth'))
    got = convert_state_dict('squeeze_tv', str(tmp_path / 's.pth'))
    want = jconv('squeeze_tv', str(tmp_path / 's.pth'))
    assert sorted(got) == sorted(squeeze_conv_shapes())
    for k, (w, b) in got.items():
        np.testing.assert_array_equal(w, want[f'{k}/kernel'].transpose(
            3, 2, 0, 1))
    with pytest.raises(ValueError):
        convert_state_dict('resnet', str(tmp_path / 's.pth'))


@pytest.mark.parametrize('fallback', ['analytic', 'random'])
def test_fallback_reports_match_jax(fresh, fallback):
    """With no converted weights: 'analytic' by default, 'random' under
    NPP_TPU_FALLBACK=random, in both packages; neither is pretrained, so
    seg_autocal='auto' rescales in both. The heads: 'asset'."""
    if fallback == 'random':
        fresh.setenv('NPP_TPU_FALLBACK', 'random')
    jax_mod = JaxAlex(owt=False)
    JP.load_tower_params('alexnet_tv', jax_mod, jnp.zeros((1, 64, 64, 3)))
    TP.load_tower_params('alexnet_tv', ALEX_CONV_SHAPES, 5, CPU)
    TP.load_lpips_lins('alex')
    JP.load_lpips_lins('alex')
    assert _reports('alexnet_tv') == (fallback, fallback)
    assert _reports('lpips_lin_alex') == ('asset', 'asset')
    autocal = [r['alexnet_tv'] is not None and not r['alexnet_tv'].pretrained
               for r in (TP.weight_reports(), JP.weight_reports())]
    assert autocal == [True, True]


def test_random_fallback_is_flax_default_init(fresh):
    """NPP_TPU_FALLBACK=random: zero biases, the same kernels for the same
    tower on every load (a generator seeded with the tower's seed),
    others for another tower name, and each kernel's standard deviation
    within 5% of flax's lecun_normal draw of the same shape (the values
    are not jax.random's, by design)."""
    fresh.setenv('NPP_TPU_FALLBACK', 'random')
    jparams = JP.load_tower_params('alexnet_tv', JaxAlex(owt=False),
                                   jnp.zeros((1, 64, 64, 3)))
    a = TP.load_tower_params('alexnet_tv', ALEX_CONV_SHAPES, 5, CPU)
    TP._TOWERS.clear()
    b = TP.load_tower_params('alexnet_tv', ALEX_CONV_SHAPES, 5, CPU)
    # (a tower's seed is its name's first four bytes: 'alex' for both
    # AlexNets, as in npp_tpu)
    other = TP.flax_default_init('vgg16', ALEX_CONV_SHAPES)
    for k in a:
        np.testing.assert_array_equal(a[k][0].numpy(), b[k][0].numpy())
        assert not np.array_equal(a[k][0].numpy(), other[k][0])
        assert float(a[k][1].abs().max()) == 0.0
        sj = float(np.std(np.asarray(jparams[k]['kernel'])))
        assert abs(float(a[k][0].std()) / sj - 1) < 0.05, k
        # truncated at two standard deviations of the untruncated normal
        fan_in = np.prod(ALEX_CONV_SHAPES[k][:3])
        bound = 2 / np.sqrt(fan_in) / .87962566103423978
        assert float(a[k][0].abs().max()) <= bound * (1 + 1e-6)


def test_pth_autocal_decision_matches_jax(fresh, tmp_path):
    """seg_autocal='auto' reads the AlexNet report: under a .pth both
    packages report 'torch', pretrained, so neither rescales the maps."""
    torch.save(_alex_state(), str(tmp_path / 'alexnet_tv.pth'))
    fresh.setenv('NPP_TPU_TORCH_WEIGHTS', str(tmp_path))
    LPIPS(CPU, net='alex')
    JaxLPIPS(net='alex')
    autocal = [not r['alexnet_tv'].pretrained
               for r in (TP.weight_reports(), JP.weight_reports())]
    assert autocal == [False, False]


@pytest.fixture(scope='module')
def squeeze():
    return LPIPS(CPU, net='squeeze'), JaxLPIPS(net='squeeze')


def test_squeeze_analytic_weights_equal_jax(squeeze):
    """SqueezeNet's analytic kernels and biases equal npp_tpu's bit for
    bit: the seeds follow npp_tpu's sorted walk (conv0, fire10, fire11,
    fire12, fire3, ...; in a fire expand1x1, expand3x3, squeeze). The
    heads are the copied asset."""
    port, jax_lp = squeeze
    assert sorted(port.tower.params) == sorted(squeeze_conv_shapes())
    for path, (w, b) in port.tower.params.items():
        d = jax_lp.params
        for p in path.split('/'):
            d = d[p]
        np.testing.assert_array_equal(
            w.numpy(), np.asarray(d['kernel']).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(b.numpy(), np.asarray(d['bias']))
    for lt, lj in zip(port.lins, jax_lp.lins):
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


@pytest.mark.parametrize('spatial', [False, True])
def test_squeeze_lpips_matches_jax(squeeze, spatial):
    """Plain LPIPS-squeeze, per layer and summed, pooled or spatial, on
    sizes whose ceil-mode pools keep a partial window: rtol 1e-5."""
    port, jax_lp = squeeze
    for s in (33, 48):
        a, b = _patches(3, n=2, s=s)
        jv, jl = jax_lp(jnp.asarray(a), jnp.asarray(b), normalize=True,
                        spatial=spatial, ret_per_layer=True)
        with torch.no_grad(), native_conv():
            tv, tl = port(_t(a), _t(b), normalize=True, spatial=spatial,
                          ret_per_layer=True)
        assert len(tl) == 7
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-7)
        for t, j in zip(tl, jl):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                       atol=1e-7)


def test_squeeze_lpips_robust_value_and_grads_match_jax(squeeze):
    """LPIPS-squeeze with per-layer adaptive robust diffs (the seven
    layers through K4's plain version on the CPU): value within rtol
    1e-5 of npp_tpu's, input and latent_scale gradients within 1e-4 of
    npp_tpu's (of each one's largest magnitude). The latent_alpha
    gradient is an f32 sum whose terms cancel: both packages' f32 sit
    2e-4 to 1.3e-3 from a float64 evaluation (npp_tpu's 1.3e-3 on relu1),
    so the port's is held within 1e-3 of float64 and 2e-3 of npp_tpu's."""
    from tests.test_torch_losses import _lpips_f64
    port, jax_lp = squeeze
    a, b = _patches(4, n=2, s=40)
    rng = np.random.RandomState(5)
    jlats = tuple(_latents(rng, c) for c in port.chns)

    def jf(x, lats):
        return jnp.mean(jax_lp(x, jnp.asarray(b), use_robust=True,
                               adaptive=lats, normalize=True))

    jv, (jgx, jglat) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(
        jnp.asarray(a), jlats)
    got = {}
    for dt, mod in ((torch.float32, port), (torch.float64, _lpips_f64(port))):
        lats = port.init_adaptive()
        for p, jl in zip(lats, jlats):
            p.load_state_dict(latents_state_dict(jax.tree.map(np.asarray,
                                                              jl)))
        lats = lats.to(dt)
        x = torch.tensor(a, dtype=dt, requires_grad=True)
        with native_conv():
            v = torch.mean(mod(x, torch.tensor(b, dtype=dt), use_robust=True,
                               adaptive=lats, normalize=True))
            v.backward()
        got[dt] = (float(v.detach()), x.grad.double().numpy(), lats)
    v, gx, lats = got[torch.float32]
    lats64 = got[torch.float64][2]
    np.testing.assert_allclose(v, float(jv), rtol=1e-5)

    def close(g, want, tol, what):
        assert np.abs(g - want).max() <= tol * np.abs(want).max(), what

    close(gx, np.asarray(jgx), 1e-4, 'input')
    for i, (p, p64, jl) in enumerate(zip(lats, lats64, jglat)):
        close(p.latent_scale.grad.numpy(), np.asarray(jl.latent_scale), 1e-4,
              f'latent_scale {i}')
        ga = p.latent_alpha.grad.double().numpy()
        close(ga, p64.latent_alpha.grad.numpy(), 1e-3, f'alpha f64 {i}')
        close(ga, np.asarray(jl.latent_alpha), 2e-3, f'alpha jax {i}')
