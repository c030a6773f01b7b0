"""K3's plain chain on the CPU against npp_tpu's contextual loss.

The same numpy inputs (N <= 4 samples, 8x8 to 12x12 feature maps, C = 16
or 32 channels) go through `npp_tpu.losses.contextual.contextual_loss`
under `jax.value_and_grad` and through the port's `contextual_loss`, whose
cosine path is the mean shift, `kernels/cx_chain.py::cx_colmax` (on the
CPU its plain version) and the tail. Value within rtol 1e-5, gradients in
x and y within rtol 1e-4 (atol 1e-4 of the largest gradient for the
entries near 0): both packages reduce their matmuls in their own order,
which the relative distance's division by the row min amplifies. The
card's cases are in tests/test_torch_kernels.py, which imports no JAX."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npp_tpu.losses import contextual as JC
from npp_tpu_torch.kernels import cx_chain, launch_counts, reset_launches
from npp_tpu_torch.losses import contextual as TC
from tests.torch_threads import few_threads  # noqa: F401  (autouse)


def _inputs(seed, n=3, h=10, w=10, c=32, dup=False, zero=False):
    """Relu features y and x near them (the fit's prediction against its
    target). dup: positions 1 and 2 of x (and of y) repeat position 0
    exactly. zero: the first two rows of x and y are zero (the fit's
    cx_pred * real_mask), so their normalised rows are equal."""
    rng = np.random.RandomState(seed)
    y = np.maximum(rng.randn(n, h, w, c), 0).astype(np.float32)
    x = (y + 0.5 * rng.randn(n, h, w, c)).astype(np.float32)
    if dup:
        for a in (x, y):
            a[:, 0, 1:3] = a[:, 0, :1]
    if zero:
        x[:, :2] = 0.0
        y[:, :2] = 0.0
    return x, y


def _jax_loss(kw, per_sample=False, groups=None):
    """npp_tpu's loss of (x, y): per_sample as a value per sample, each
    called alone; groups as the sum over equal groups of samples, each
    called alone (how the port defines both)."""
    def loss(x, y):
        if per_sample:
            return jnp.sum(jnp.stack([
                JC.contextual_loss(x[i:i + 1], y[i:i + 1], **kw)
                for i in range(x.shape[0])]) * jnp.arange(1.0, x.shape[0] + 1))
        if groups is not None:
            size = x.shape[0] // groups
            return sum(JC.contextual_loss(x[i:i + size], y[i:i + size], **kw)
                       * (1.0 + i // size) for i in range(0, x.shape[0], size))
        return JC.contextual_loss(x, y, **kw)
    return loss


def _port_loss(kw, per_sample=False, groups=None):
    def loss(x, y):
        v = TC.contextual_loss(x, y, per_sample=per_sample, groups=groups,
                               **kw)
        if per_sample or groups is not None:
            return torch.sum(v * torch.arange(1.0, v.shape[0] + 1))
        return v
    return loss


def _compare(x, y, kw_np, per_sample=False, groups=None):
    """Value and gradients in x and y of both packages; returns the port's
    gradients."""
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw_np.items()}
    tkw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw_np.items()}
    jv, (jgx, jgy) = jax.value_and_grad(
        _jax_loss(jkw, per_sample, groups), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(y))
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    v = _port_loss(tkw, per_sample, groups)(xt, yt)
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(jv), rtol=1e-5)
    for got, want in ((xt.grad, jgx), (yt.grad, jgy)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    return xt.grad.numpy(), yt.grad.numpy()


def _mask(seed, n, h, w, all_masked=None):
    fv = (np.random.RandomState(seed + 1).rand(n, h, w) > 0.3).astype(
        np.float32)
    if all_masked is not None:
        fv[all_masked] = 0.0
    return fv


CASES = {
    'plain': dict(),
    'band_width': dict(kw=dict(band_width=0.2)),
    'feat_valid': dict(mask=True),
    'feat_valid_one_sample_all_masked': dict(mask=True, all_masked=1),
    'per_sample': dict(per_sample=True, n=4),
    'groups_2': dict(groups=2, n=4),
    'weight': dict(weight=True),
    'valid': dict(valid=True),
    'weight_and_valid': dict(weight=True, valid=True),
    'zeroed_rows': dict(zero=True),
    'small_map_16_channels': dict(n=2, h=8, w=8, c=16),
    'wide_map_ragged': dict(n=2, h=12, w=11, c=32),
}


@pytest.mark.parametrize('case', list(CASES))
def test_cx_matches_npp_tpu(case):
    spec = CASES[case]
    n, h, w, c = (spec.get(k, d) for k, d in (('n', 3), ('h', 10), ('w', 10),
                                              ('c', 32)))
    seed = sorted(CASES).index(case)
    x, y = _inputs(seed, n, h, w, c, zero=spec.get('zero', False))
    kw = dict(spec.get('kw', {}))
    rng = np.random.RandomState(seed + 7)
    if spec.get('mask'):
        kw['feat_valid'] = _mask(seed, n, h, w, spec.get('all_masked'))
    if spec.get('weight'):
        kw['weight'] = (rng.rand(n) + 0.5).astype(np.float32)
    if spec.get('valid'):
        kw['valid'] = np.array([True, False, True][:n])
    _compare(x, y, kw, spec.get('per_sample', False), spec.get('groups'))


@pytest.mark.parametrize('masked', [False, True])
def test_exact_duplicates_split_the_gradient_evenly(masked):
    """Positions 1 and 2 repeat position 0 in x and in y: the rows tie in
    every column's max and the columns in every row's min. Both packages
    split the gradient evenly among tied elements, so the three positions'
    gradients are equal and match npp_tpu's."""
    x, y = _inputs(11, dup=True)
    kw = {}
    if masked:
        fv = _mask(11, *x.shape[:3])
        fv[:, 0, :3] = 1.0
        kw['feat_valid'] = fv
    gx, gy = _compare(x, y, kw)
    for g in (gx, gy):
        np.testing.assert_allclose(g[:, 0, 1], g[:, 0, 0], rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(g[:, 0, 2], g[:, 0, 0], rtol=1e-6,
                                   atol=1e-12)
        assert np.abs(g[:, 0, 0]).max() > 0


def test_tied_rows_share_the_column_max_gradient():
    """cx_colmax_plain at a column whose max two identical rows share:
    each row gets half of the gradient a single row would."""
    gen = torch.Generator().manual_seed(3)
    yn = torch.nn.functional.normalize(torch.randn(1, 5, 16, generator=gen),
                                       dim=-1)
    xn = torch.nn.functional.normalize(torch.randn(1, 4, 16, generator=gen),
                                       dim=-1)
    once = xn.clone().requires_grad_()
    twice = torch.cat([xn, xn[:, :1]], 1).requires_grad_()
    g = torch.rand(1, 5, generator=gen)
    (cx_chain.cx_colmax_plain(once, yn, 0.5) * g).sum().backward()
    (cx_chain.cx_colmax_plain(twice, yn, 0.5) * g).sum().backward()
    z = cx_chain.cx_colmax_plain(once, yn, 0.5)
    torch.testing.assert_close(
        cx_chain.cx_colmax_plain(twice, yn, 0.5), z, rtol=0, atol=0)
    torch.testing.assert_close(twice.grad[:, 0], twice.grad[:, 4], rtol=0,
                               atol=0)
    # the columns row 0 wins: its gradient there is split between the copies
    torch.testing.assert_close(twice.grad[:, 0] + twice.grad[:, 4],
                               once.grad[:, 0], rtol=1e-5, atol=1e-7)


def test_cx_colmax_on_the_cpu_is_the_plain_chain_and_launches_nothing():
    reset_launches()
    x, y = _inputs(5)
    fv = torch.as_tensor(_mask(5, *x.shape[:3]).reshape(x.shape[0], -1))
    xn, yn = TC.normalized_features(torch.as_tensor(x), torch.as_tensor(y))
    for mask in (None, fv):
        assert torch.equal(cx_chain.cx_colmax(xn, yn, 0.5, mask),
                           cx_chain.cx_colmax_plain(xn, yn, 0.5, mask))
    # the plain chain is the distance path of npp_tpu's chain, as the
    # 'l1' / 'l2' forms take it
    dist = TC.compute_cosine_distance(torch.as_tensor(x), torch.as_tensor(y))
    assert torch.equal(cx_chain.colmax_of_distance(dist, 0.5),
                       cx_chain.cx_colmax_plain(xn, yn, 0.5))
    TC.contextual_loss(torch.as_tensor(x), torch.as_tensor(y))
    assert not any(v for k, v in launch_counts().items()
                   if k.startswith('cx_chain'))


def test_cx_colmax_rejects_mixed_devices_and_bad_shapes():
    xn = torch.zeros(2, 9, 32)
    with pytest.raises(RuntimeError):
        cx_chain.cx_colmax(xn, torch.zeros(2, 9, 32, device='meta'), 0.5)


def test_splits_follow_the_blocks_in_flight():
    """The flagship fit (6 x 1,600) splits its streamed tiles four ways on
    an H100's 132 SMs; the search's evaluation (3 x 12,288) and a small
    patch's 256 positions do not split."""
    assert cx_chain.splits_for(6, 1600, 1600, 132) == 4
    assert cx_chain.splits_for(18, 1600, 1600, 132) == 2
    assert cx_chain.splits_for(3, 12288, 12288, 132) == 1
    assert cx_chain.splits_for(6, 256, 256, 132) == 2
    assert cx_chain.splits_for(1, 40, 40, 132) == 1
    # 25 tiles: six splits of five would leave the sixth without a tile
    assert cx_chain.splits_for(6, 784, 784, 132) == 5


@pytest.mark.parametrize('n', [1, 2, 6, 8, 18])
def test_no_split_is_left_without_a_tile(n):
    """Every split of either sweep gets at least one streamed tile, as
    csrc/cx_chain.cu's split_range divides them, for P, Q up to 1,600."""
    for p in range(1, 1601, 7):
        for q in (p, p + 40, max(1, p - 33)):
            splits = cx_chain.splits_for(n, p, q, 132)
            for rows in (p, q):
                nt = -(-rows // cx_chain.TILE)
                per = -(-nt // splits)
                assert (splits - 1) * per < nt, (n, p, q, splits)
