"""Port parity on the CPU for the search's lockstep fit: the stacked
NPPNetLight against npp_tpu's and the reference golden, one lockstep step
per candidate against npp_tpu's vmapped value_and_grad, the one-launch K4
layout of the candidates' pixel losses, and K2's batched plain version."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npp_tpu.config import SearchConfig as JaxSearchConfig
from npp_tpu.config import replace as jax_replace
from npp_tpu.nn.mlp import NPPNetLight as JaxNPPNetLight
from npp_tpu.proposal import ranking as JR
from npp_tpu_torch.config import SearchConfig, replace
from npp_tpu_torch.kernels import snake
from npp_tpu_torch.losses.pixel import img2mse
from npp_tpu_torch.losses.robust import adaptive_init, stacked_nll_mean_sum
from npp_tpu_torch.nn.mlp import NPPNetLight
from npp_tpu_torch.proposal import ranking as TR
from npp_tpu_torch.utils.convert import params_from_jax
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), 'goldens')
SMALL = dict(netdepth=2, netwidth=32, N_rand=96, matmul_precision='float32')
N_CAND = 3
ANGLES = [[90.0, 180.0], [45.0, 135.0], [80.0, 170.0]]
PERIODS = [[16.0, 12.0], [7.0, 5.0], [11.5, 23.0]]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _stacked_jax_params(cfg, seed=0):
    """npp_tpu's ranking init broadcast to N_CAND candidates, then moved
    apart per candidate by seeded noise (so a candidate's gradient that
    took another's parameters would show)."""
    core = JR._rank_core(cfg)
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: np.asarray(x)[None] + 0.05 * rng.randn(
            N_CAND, *x.shape).astype(np.float32), core['params0'])


def _assert_scaled(got, want, rtol, what):
    """|got - want| <= rtol * max|want| over the whole tensor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (what, err)


def test_stacked_light_matches_npp_tpu_and_golden():
    """Every candidate of the stacked model at params_from_jax of npp_tpu's
    per-candidate parameters gives npp_tpu's output (1e-5), and the
    reference golden's (tests/goldens/nppnet_light.npz, as
    tests/test_mlp.py holds npp_tpu to it)."""
    g = np.load(os.path.join(GOLDEN_DIR, 'nppnet_light.npz'))
    jmodel = JaxNPPNetLight(input_ch_periodic_all=20, n_scales=1,
                            n_offsets=5, n_angle_offsets=1, depth=4,
                            width=32, activation='snake')
    lin = {f'periodic_{i}': f'periodic_linears.{i}' for i in range(4)}
    lin.update(feature1='feature_linear1', rgb='rgb_linear',
               pos_0='pos_linears.0')
    golden = {k: {'kernel': g[f'sd_{v}.weight'].T, 'bias': g[f'sd_{v}.bias']}
              for k, v in lin.items()}
    rng = np.random.RandomState(0)
    cands = [golden] + [jax.tree.map(
        lambda x: (x + 0.1 * rng.randn(*x.shape)).astype(np.float32), golden)
        for _ in range(2)]
    x_peri = np.stack([g['x_peri'] + 0.1 * i for i in range(3)])
    model = NPPNetLight(3, 20, 42, torch.Generator().manual_seed(0),
                        depth=4, width=32)
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *cands)
    model.load_state_dict(params_from_jax({'mlp': stacked})['mlp'])
    with torch.no_grad():
        got = model(torch.tensor(g['x_pos']), torch.tensor(x_peri)).numpy()
    for i, p in enumerate(cands):
        want = np.asarray(jmodel.apply({'params': p}, g['x_pos'], x_peri[i]))
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0], g['y'], rtol=1e-4, atol=1e-5)


def test_light_init_broadcasts_one_draw_with_jax_shapes():
    """One init for every candidate (npp_tpu ranking.py:94-99), in the flax
    names and layout, from U(+-1/sqrt(fan_in)); at npp_tpu's init
    (params_from_jax) the stacked model gives npp_tpu's outputs (1e-5)."""
    cfg = replace(SearchConfig(), **SMALL)
    params = TR.init_rank_params(cfg, N_CAND, torch.device('cpu'))
    jcfg = jax_replace(JaxSearchConfig(), **SMALL)
    core = JR._rank_core(jcfg)
    want = _np_tree(core['params0']['mlp'])
    rng = np.random.RandomState(4)
    x_pos = rng.randn(50, 42).astype(np.float32)
    x_peri = rng.randn(50, 20).astype(np.float32)
    jout = np.asarray(core['model'].apply({'params': want}, x_pos, x_peri))
    model = TR.init_rank_params(cfg, N_CAND, torch.device('cpu')).mlp
    model.load_state_dict(params_from_jax({'mlp': jax.tree.map(
        lambda x: np.repeat(x[None], N_CAND, 0), want)})['mlp'])
    with torch.no_grad():
        got = model(torch.tensor(x_pos),
                    torch.tensor(x_peri)[None].expand(N_CAND, -1, -1))
    for b in range(N_CAND):
        np.testing.assert_allclose(got[b].numpy(), jout, rtol=1e-5,
                                   atol=1e-5)
    for name, p in want.items():
        layer = getattr(params.mlp, name)
        assert tuple(layer.kernel.shape) == (N_CAND,) + p['kernel'].shape
        assert tuple(layer.bias.shape) == (N_CAND,) + p['bias'].shape
        assert torch.equal(layer.kernel, layer.kernel[:1].expand_as(
            layer.kernel))
        bound = 1.0 / np.sqrt(p['kernel'].shape[0])
        assert float(layer.kernel.detach().abs().max()) <= bound
    lat = params.adaptive_pix
    assert tuple(lat.latent_alpha.shape) == (N_CAND, 1, 3)


def _batch(seed=1, n=96, h=40, w=48):
    rng = np.random.RandomState(seed)
    img = rng.rand(h, w, 3).astype(np.float32)
    coords = np.stack([rng.randint(0, h, n), rng.randint(0, w, n)], 1)
    return img, coords.astype(np.float32), img[coords[:, 0], coords[:, 1]]


def test_lockstep_step_matches_npp_tpu_per_candidate():
    """One lockstep step on an injected batch: the summed loss and every
    candidate's gradients (MLP and pixel-loss latents) equal npp_tpu's
    jax.vmap(jax.value_and_grad(one_cand_loss)); each candidate's loss,
    run alone, equals npp_tpu's. f32 on both sides: loss rtol 1e-4,
    gradients within 2e-3 of each tensor's largest magnitude (the
    completion step test's tolerances)."""
    jcfg = jax_replace(JaxSearchConfig(), **SMALL)
    cfg = replace(SearchConfig(), **SMALL)
    jp = _stacked_jax_params(jcfg)
    img, coords, gt = _batch()
    norm = (40, 48)
    bands = np.random.RandomState(2).randn(cfg.multires).astype(
        np.float32) * 10
    norm_hw = jnp.asarray(np.concatenate([np.float32(norm), bands]))
    one = JR._rank_core(jcfg)['one_cand_loss']
    losses, grads = jax.jit(jax.vmap(lambda p, a, pe: jax.value_and_grad(
        one)(p, a, pe, jnp.asarray(coords), jnp.asarray(gt), norm_hw)))(
        jp, jnp.asarray(ANGLES, jnp.float32),
        jnp.asarray(PERIODS, jnp.float32))
    losses, grads = np.asarray(losses), _np_tree(grads)

    cpu = torch.device('cpu')
    params = TR.init_rank_params(cfg, N_CAND, cpu)
    conv = params_from_jax(_np_tree(jp))
    params.mlp.load_state_dict(conv['mlp'])
    params.adaptive_pix.load_state_dict(conv['adaptive_pix'])
    lat = TR.Lattices(cfg, ANGLES, PERIODS, bands, norm, cpu)
    loss = TR.rank_loss(params, lat, torch.tensor(coords), torch.tensor(gt))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), losses.sum(), rtol=1e-4)
    for name, p in grads['mlp'].items():
        layer = getattr(params.mlp, name)
        for b in range(N_CAND):
            _assert_scaled(layer.kernel.grad[b].numpy(), p['kernel'][b],
                           2e-3, (name, b))
            _assert_scaled(layer.bias.grad[b].numpy(), p['bias'][b], 2e-3,
                           (name, b))
    for f in ('latent_alpha', 'latent_scale'):
        for b in range(N_CAND):
            _assert_scaled(getattr(params.adaptive_pix, f).grad[b].numpy(),
                           getattr(grads['adaptive_pix'], f)[b], 2e-3,
                           (f, b))

    for b in range(N_CAND):
        alone = TR.init_rank_params(cfg, 1, cpu)
        one_b = jax.tree.map(lambda x: x[b:b + 1], _np_tree(jp))
        conv_b = params_from_jax(one_b)
        alone.mlp.load_state_dict(conv_b['mlp'])
        alone.adaptive_pix.load_state_dict(conv_b['adaptive_pix'])
        lat_b = TR.Lattices(cfg, ANGLES[b:b + 1], PERIODS[b:b + 1], bands,
                            norm, cpu)
        with torch.no_grad():
            got = TR.rank_loss(alone, lat_b, torch.tensor(coords),
                               torch.tensor(gt))
        np.testing.assert_allclose(float(got), losses[b], rtol=1e-4)


def test_summed_candidate_k4_layout_gives_each_its_own_gradient():
    """stacked_nll_mean_sum lays the candidates' (N, 3) residuals side by
    side as one (N, 3 n) matrix, so its row sums mix candidates: its value
    is the sum of the candidates' own adaptive losses, and its gradient in
    each candidate's residual and latents is that candidate's own loss's
    (float64, so only the layout is under test: 1e-12)."""
    rng = np.random.RandomState(3)
    n, m = 4, 50
    diff = torch.tensor(rng.randn(n, m, 3) * 0.2, requires_grad=True)
    stacked = adaptive_init(3, n_stack=n).double()
    with torch.no_grad():
        stacked.latent_alpha.copy_(torch.tensor(rng.randn(n, 1, 3)))
        stacked.latent_scale.copy_(torch.tensor(rng.randn(n, 1, 3)))
    total = stacked_nll_mean_sum(diff, stacked)
    total.backward()
    want = 0.0
    for b in range(n):
        alone = adaptive_init(3).double()
        with torch.no_grad():
            alone.latent_alpha.copy_(stacked.latent_alpha[b])
            alone.latent_scale.copy_(stacked.latent_scale[b])
        d = diff.detach()[b].clone().requires_grad_()
        loss = img2mse(d, torch.zeros_like(d), 'robust_loss_adaptive', alone)
        loss.backward()
        want += float(loss.detach())
        torch.testing.assert_close(diff.grad[b], d.grad, rtol=1e-12,
                                   atol=1e-12)
        torch.testing.assert_close(stacked.latent_alpha.grad[b],
                                   alone.latent_alpha.grad, rtol=1e-12,
                                   atol=1e-12)
        torch.testing.assert_close(stacked.latent_scale.grad[b],
                                   alone.latent_scale.grad, rtol=1e-12,
                                   atol=1e-12)
    np.testing.assert_allclose(float(total.detach()), want, rtol=1e-12)


@pytest.mark.parametrize('b', [1, 3])
def test_k2_batched_plain_equals_separate_calls(b):
    """bias_snake on (B, M, N) with a bias per batch: values and gradients
    of B separate (M, N) calls, and B = 1 agrees with the 2-D form."""
    gen = torch.Generator().manual_seed(b)
    h = torch.randn(b, 37, 16, generator=gen, requires_grad=True)
    bias = torch.randn(b, 16, generator=gen, requires_grad=True)
    g = torch.randn(b, 37, 16, generator=gen)
    y = snake.bias_snake(h, bias)
    y.backward(g)
    for i in range(b):
        hi = h.detach()[i].clone().requires_grad_()
        bi = bias.detach()[i].clone().requires_grad_()
        yi = snake.bias_snake(hi, bi)
        yi.backward(g[i])
        torch.testing.assert_close(y[i], yi, rtol=0, atol=0)
        torch.testing.assert_close(h.grad[i], hi.grad, rtol=0, atol=0)
        torch.testing.assert_close(bias.grad[i], bi.grad, rtol=1e-6,
                                   atol=1e-6)
