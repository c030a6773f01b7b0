"""Port parity on the CPU for the warp field (cfg.warp_field): WarpField with
parameters carried over from `npp_tpu`'s flax module, its flax-like
initialisation, the coordinate gradient of K1's plain version against
jax.grad of `npp_tpu`'s TaskEmbedder.embed at non-integer coordinates, one
warp fit step against JAX, and a small fit that builds no table."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npp_tpu.config import CompletionConfig as JaxCompletionConfig
from npp_tpu.config import replace as jax_replace
from npp_tpu.models import pipeline as JP
from npp_tpu.models import sampler as JS
from npp_tpu.models import trainer as JT
from npp_tpu.models.completion import COMPLETION_TASK
from npp_tpu.models.loaders import TaskData as JaxTaskData
from npp_tpu.nn import embedder as JE
from npp_tpu.nn import warp as JW
from npp_tpu_torch import config as TC
from npp_tpu_torch.kernels import launch_counts
from npp_tpu_torch.models import pipeline as TP
from npp_tpu_torch.models import sampler as TS
from npp_tpu_torch.models import trainer as TT
from npp_tpu_torch.models.loaders import TaskData
from npp_tpu_torch.nn import warp as TW
from npp_tpu_torch.nn.embedder import TaskEmbedder
from npp_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_trainer import _assert_scaled, _tiny_arrays
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

CPU = torch.device('cpu')


def _jax_warp(width=16, depth=2, max_px=8.0, seed=0):
    """A flax WarpField and its parameters moved off their init (the output
    layer nonzero), as numpy."""
    wf = JW.WarpField(width=width, depth=depth, max_px=max_px)
    p = wf.init(jax.random.PRNGKey(seed), jnp.zeros((1, 2)))['params']
    rng = np.random.RandomState(seed)
    p = jax.tree.map(lambda a: np.asarray(a) + 0.3 * rng.randn(*a.shape)
                     .astype(np.float32), p)
    return wf, p


def test_warp_field_with_converted_params_matches_jax():
    """Outputs, warped coordinates and parameter gradients within 1e-5 of
    the largest (sin and tanh of the same f32 products)."""
    wf, p = _jax_warp()
    res = (40, 48)
    rng = np.random.RandomState(1)
    coords = (rng.rand(200, 2) * np.array(res)).astype(np.float32)
    g = rng.randn(200, 2).astype(np.float32)
    jw = JW.warp_coords(wf, p, jnp.asarray(coords), res)
    jgrad = jax.grad(lambda q: jnp.sum(JW.warp_coords(
        wf, q, jnp.asarray(coords), res) * g))(p)

    tw = TW.WarpField(width=16, depth=2, max_px=8.0)
    tw.load_state_dict(params_from_jax({'warp': p})['warp'])
    out = TW.warp_coords(tw, torch.tensor(coords), res)
    torch.sum(out * torch.tensor(g)).backward()
    _assert_scaled(out.detach().numpy() - coords, np.asarray(jw) - coords,
                   1e-5, 'delta')
    for name in ('dense0', 'dense1', 'out'):
        lin = getattr(tw, name)
        _assert_scaled(lin.weight.grad.numpy().T, jgrad[name]['kernel'], 1e-5,
                       name)
        _assert_scaled(lin.bias.grad.numpy(), jgrad[name]['bias'], 1e-5, name)


def test_warp_init_follows_flax_dense():
    """Identity at init (zero output layer), zero biases, lecun-normal
    hidden kernels (truncated at two standard deviations, std
    sqrt(1/fan_in) like flax's, checked on a wide layer against flax's own
    draw within 5%), bounded by max_px, drawn from the explicit generator
    only."""
    state = torch.random.get_rng_state()
    tw = TW.WarpField(width=512, depth=2, max_px=8.0,
                      gen=torch.Generator().manual_seed(0))
    assert torch.equal(state, torch.random.get_rng_state())
    x = torch.rand(64, 2) * 2 - 1
    assert torch.equal(tw(x), torch.zeros(64, 2))
    jp = JW.WarpField(width=512, depth=2).init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 2)))['params']
    for name, fan_in in (('dense0', 2), ('dense1', 512)):
        w = getattr(tw, name).weight.detach().numpy()
        std = np.sqrt(1.0 / fan_in)
        assert np.abs(w).max() <= 2 * std / TW.TRUNC_STD + 1e-6
        jstd = float(np.std(np.asarray(jp[name]['kernel'])))
        assert abs(w.std() - jstd) < 0.05 * jstd, (name, w.std(), jstd)
        assert not getattr(tw, name).bias.detach().any()
    with torch.no_grad():
        for q in tw.parameters():
            q.add_(100.0)
    assert float(tw(x).abs().max()) <= 8.0 + 1e-5
    cfg = TC.replace(TC.CompletionConfig())
    assert TW.make_warp(cfg) is None


def test_k1_plain_coordinate_gradient_matches_jax():
    """The embedding's gradient in non-integer coordinates (three lattices,
    ten Fourier bands, the default offsets): the port's K1 plain version by
    autograd against jax.grad of npp_tpu's TaskEmbedder.embed, within 1e-4
    of the largest (both differentiate the same f32 phases, whose rounding
    at projections of a few hundred pixels is a few 1e-5 of a period)."""
    rng = np.random.RandomState(0)
    res = (96, 128)
    coords = (rng.rand(300, 2) * np.array(res)).astype(np.float32)
    angles = np.array([[90.0, 180.0], [10.0, 100.0], [45.0, 135.0]],
                      np.float32)
    periods = np.array([[24.0, 28.0], [12.0, 14.5], [48.0, 56.0]], np.float32)
    bands = (rng.randn(10) * 10).astype(np.float32)
    offsets = (0.0, -1.0, 1.0, 0.5, -0.5)
    d = 3 * 22 * 21
    g = rng.randn(300, d).astype(np.float32)
    jemb = JE.TaskEmbedder(freq_bands=jnp.asarray(bands),
                           angles=jnp.asarray(angles),
                           periods=jnp.asarray(periods), res=res,
                           freq_scales=(1.0,), freq_offsets=offsets,
                           angle_offsets=(0.0,), out_dim=d, top1_dim=d // 3)
    jgrad = jax.grad(lambda c: jnp.sum(jemb.embed(c) * g))(
        jnp.asarray(coords))
    temb = TaskEmbedder(freq_bands=torch.tensor(bands),
                        angles=torch.tensor(angles),
                        periods=torch.tensor(periods), res=res,
                        freq_scales=(1.0,), freq_offsets=offsets,
                        angle_offsets=(0.0,), out_dim=d, top1_dim=d // 3)
    tc = torch.tensor(coords, requires_grad=True)
    torch.sum(temb.embed(tc) * torch.tensor(g)).backward()
    _assert_scaled(tc.grad.numpy(), jgrad, 1e-4, 'dcoords')
    assert float(np.abs(np.asarray(jgrad)).min()) > 0


TINY = dict(netwidth=32, netdepth=6, N_rand=64, patch_num=1,
            num_real_patch_per_sample=2, use_perceptual_loss=False,
            warp_field=True, warp_width=16, warp_max_px=6.0)


def test_warp_fit_step_matches_jax(monkeypatch):
    """One completion step with the warp field (its output layer moved off
    zero, so every warp parameter gets a gradient), the pixel and CX terms,
    the same MLP, latents, bands, warp, pixel indices and PatchBatch on
    both sides, f32: loss rtol 1e-4, every gradient within 2e-3 of each
    tensor's largest magnitude (the CX softmax amplifies convolution
    reassociation, as in tests/test_torch_trainer.py)."""
    cfg = jax_replace(JaxCompletionConfig(), matmul_precision='float32',
                      **TINY)
    arrays = _tiny_arrays()
    jdata = JaxTaskData(**arrays)
    comps = JP.build_components(cfg, jdata, COMPLETION_TASK)
    state, _ = JT.init_fit_state(cfg, COMPLETION_TASK, comps.model,
                                 comps.embedder, jax.random.PRNGKey(0),
                                 comps.percep, comps.style)
    params = dict(state.params)
    params['warp'] = _jax_warp(16, 2, 6.0)[1]
    consts = JP.make_fit_consts(cfg, COMPLETION_TASK, jdata, 16)
    for i in range(100):
        batch = JS.sample_patches(jax.random.PRNGKey(i), consts.sampler, 1,
                                  16, 2, cfg.invalid_ratio)
        if float(np.asarray(batch.valid).sum()) == 2:
            break
    monkeypatch.setattr(JT, 'sample_patches', lambda *a, **k: batch)
    jloss_fn = JT.build_loss_fn(cfg, COMPLETION_TASK, comps.model,
                                comps.percep, comps.contextual, comps.style,
                                1, 16)
    key = jax.random.PRNGKey(7)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, comps.embedder, consts, key), has_aux=True))(
        params)
    pix_idx = jax.random.randint(jax.random.split(key)[0], (cfg.N_rand,), 0,
                                 consts.pool_train_n)

    tcfg = TC.replace(TC.CompletionConfig(), **TINY)
    tdata = TaskData(**arrays)
    tcomps = TP.build_components(tcfg, tdata, CPU)
    tstate = TT.init_fit_state(tcfg, tcomps.model, tcomps.percep, CPU)
    npy = jax.tree.map(np.asarray, params)
    conv = params_from_jax({
        'mlp': npy['mlp'], 'adaptive_pix': npy['adaptive_pix'],
        'warp': npy['warp'],
        'embedder': {'freq_bands': np.asarray(comps.embedder.freq_bands)}})
    tstate.params.mlp.load_state_dict(conv['mlp'])
    tstate.params.adaptive_pix.load_state_dict(conv['adaptive_pix'])
    tstate.params.warp.load_state_dict(conv['warp'])
    tcomps.embedder.freq_bands = conv['embedder']['freq_bands']
    tbatch = TS.PatchBatch(*[torch.as_tensor(np.array(v)) for v in
                             batch[:-1]], int(batch.source))
    tbatch.fake_coords = tbatch.fake_coords.long()
    tloss_fn = TT.build_loss_fn(tcfg, tcomps.percep, tcomps.contextual, 1, 16,
                                inject=(torch.as_tensor(np.asarray(pix_idx)
                                                        ).long(), tbatch))
    with torch.backends.mkldnn.flags(enabled=False):
        loss, metrics = tloss_fn(tstate.params, tcomps.embedder,
                                 TP.make_fit_consts(tcfg, tdata, 16, CPU),
                                 None)
        loss.backward()

    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    for k in ('pixel', 'contextual'):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    for tree, mod in ((jg['mlp'], tstate.params.mlp),
                      (jg['warp'], tstate.params.warp)):
        for name, p in tree.items():
            lin = getattr(mod, name)
            _assert_scaled(lin.weight.grad.numpy().T, p['kernel'], 2e-3, name)
            _assert_scaled(lin.bias.grad.numpy(), p['bias'], 2e-3, name)
    assert float(np.abs(jg['warp']['dense0']['kernel']).max()) > 0
    for f in ('latent_alpha', 'latent_scale'):
        _assert_scaled(getattr(tstate.params.adaptive_pix, f).grad,
                       getattr(jg['adaptive_pix'], f), 2e-3, f)


@pytest.mark.parametrize('table', ['float32', 'bfloat16'])
def test_warp_fit_builds_no_table(table, monkeypatch):
    """With the warp on, every block embeds on the fly (warped coordinates
    are not canvas pixels; npp_tpu/models/trainer.py:293-297) whatever
    embed_table says; the fit runs, the warp moves off the identity and the
    render warps. No kernel launches on the CPU."""
    built = []
    monkeypatch.setattr(TT, 'make_embedding_table',
                        lambda *a, **k: built.append(1))
    cfg = TC.replace(TC.CompletionConfig(), embed_table=table, N_iters=17,
                     i_testset=8, i_print=8, use_contextual_loss=False,
                     **TINY)
    data = TaskData(**_tiny_arrays())
    res = TP.fit_image(cfg, data, device='cpu', log_every=cfg.i_print)
    assert not built and len(res.history) == 2
    assert TT.table_dtype(cfg, res.components.embedder, 8) is None
    assert TT.table_dtype(TC.replace(cfg, warp_field=False),
                          res.components.embedder, 8) is not None
    warp = res.state.params.warp
    assert float(warp.out.weight.detach().abs().max()) > 0
    out = res.render(res.state.params, 40, 48)
    with torch.no_grad():
        warp.out.weight.zero_()
        warp.out.bias.zero_()
    assert not torch.equal(out, res.render(res.state.params, 40, 48))
    assert not any(launch_counts().values())
