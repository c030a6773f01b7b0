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


# the kernel's geometry at every path's shape (N, P = Q, C): the scratch
# pitches (Q and P rounded up to 32), the column pass's chunks of 64 rows,
# the forward product's 128 x 128 tiles and the bytes of s
PLANS = {
    'fit': ((6, 1600, 256), 1600, 25, 6 * 13 * 13, 61_440_000),
    'batched': ((18, 1600, 256), 1600, 25, 18 * 13 * 13, 184_320_000),
    'patch64': ((6, 256, 256), 256, 4, 6 * 2 * 2, 1_572_864),
    'search': ((3, 12288, 256), 12288, 192, 3 * 96 * 96, 1_811_939_328),
    'p784': ((6, 784, 256), 800, 13, 6 * 7 * 7, 15_052_800),
    'p1601': ((2, 1601, 256), 1632, 26, 2 * 13 * 13, 20_902_656),
}


@pytest.mark.parametrize('path', list(PLANS))
def test_plan_at_the_paths_shapes(path):
    (n, p, c), ld, chunks, tiles, s_bytes = PLANS[path]
    pl = cx_chain.plan(n, p, p, c)
    assert (pl.ld, pl.ldt, pl.chunks) == (ld, ld, chunks)
    assert pl.product_tiles(p, p) == tiles
    fwd = cx_chain.buffer_bytes(pl.forward_buffers('cosine',
                                                   cx_chain.PREC_TF32))
    assert fwd['s'] == s_bytes == 4 * n * p * ld
    assert fwd['cmax'] == fwd['ccnt'] == 4 * chunks * n * p
    assert fwd['xs'] == fwd['ys'] == 4 * n * p * c
    # f32 and l1 take no rounded copies
    assert 'xs' not in pl.forward_buffers('cosine', cx_chain.PREC_F32)
    assert 'xs' not in pl.forward_buffers('l1', cx_chain.PREC_TF32)
    # the backward's products: dxn over (P, C) tiles with K = Q
    assert pl.product_tiles(p, c) == n * -(-p // 128) * -(-c // 128)
    bwd = cx_chain.buffer_bytes(pl.backward_buffers('cosine', True, True))
    assert bwd['gx'] == bwd['gy'] == s_bytes
    assert bwd['ys'] == bwd['xs'] == 4 * n * c * ld
    # a fit that wants dxn alone allocates no G^T, no x^T and no dyn
    assert set(pl.backward_buffers('cosine', True, False)) == {
        'terms', 'gx', 'ys', 'dx'}
    assert set(pl.backward_buffers('l1', True, True)) == {'terms', 'rsum',
                                                          'csum'}
    assert set(pl.backward_buffers('l2', True, True)) >= {'gx', 'gy', 'rsum',
                                                          'csum'}


class _FakeCard:
    """K3's launchers replaced by a model of their contract in PyTorch on
    the CPU, so that the wrapper's autograd Function, its routing and its
    l2 / l1 algebra run here: the forward returns z and Saved with s (the
    product, or l1's difference of the sums); the backward works from the
    saved s alone (never from x and y's product) and returns the kernel's
    products G y and G^T x and its partial sums. Records each call."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(cx_chain, '_on_card', lambda *t: True)
        monkeypatch.setattr(cx_chain, 'cx_fwd_launch', self.fwd)
        monkeypatch.setattr(cx_chain, 'cx_bwd_launch', self.bwd)
        for mode in cx_chain.PLAIN:
            monkeypatch.setitem(cx_chain.PLAIN, mode, self.no_plain)

    @staticmethod
    def no_plain(*args):
        raise AssertionError('a card tensor reached the plain chain')

    @staticmethod
    def chain(s, xx, yy, fv, band_width, mode):
        if mode == 'cosine':
            d = 1.0 - torch.clamp(s, 0.0, 1.0)
        elif mode == 'l2':
            d = torch.clamp(yy[:, None, :] - 2 * s + xx[:, :, None], min=0.0)
        else:
            d = torch.clamp(torch.abs(s), min=0.0)
        return cx_chain.colmax_of_distance(d, band_width, fv)

    def fwd(self, x, y, fv, band_width, prec, mode='cosine', xx=None,
            yy=None, keep=True):
        self.calls.append(('fwd', mode, keep))
        s = x[:, :, None] - y[:, None, :] if mode == 'l1' else \
            torch.bmm(x, y.transpose(1, 2))
        z = self.chain(s, xx, yy, fv, band_width, mode)
        n, p, q = s.shape
        stats = torch.zeros(n, p)
        ints = torch.zeros(n, p, dtype=torch.int32)
        return z, (cx_chain.Saved(s, stats, ints, stats, ints)
                   if keep else None)

    def bwd(self, g, x, y, fv, saved, z, band_width, prec, mode='cosine',
            xx=None, yy=None, need_dx=True, need_dy=True):
        self.calls.append(('bwd', mode, need_dx, need_dy))
        with torch.enable_grad():
            s = saved.s.detach().requires_grad_()
            gs, = torch.autograd.grad(
                self.chain(s, xx, yy, fv, band_width, mode), s, g)
        if mode == 'l1':
            return None, None, -gs.sum(2), -gs.sum(1)
        dx = torch.bmm(gs, y) if need_dx else None
        dy = torch.bmm(gs.transpose(1, 2), x) if need_dy else None
        sums = (gs.sum(2), gs.sum(1)) if mode == 'l2' else (None, None)
        return (dx, dy) + sums


@pytest.mark.parametrize('loss_type', ['cosine', 'l2', 'l1'])
def test_each_loss_type_takes_its_kernel_form_on_the_card(monkeypatch,
                                                          loss_type):
    """On card tensors (the launchers faked on the CPU) each loss_type
    launches its own form both ways, never the plain chain, and the
    wrapper's gradient (l2's norm terms, l1's sums and signs) matches
    npp_tpu's with a mask."""
    card = _FakeCard(monkeypatch)
    x, y = (_inputs if loss_type == 'cosine' else _normal_inputs)(21, c=32)
    fv = _mask(21, *x.shape[:3])
    _compare(x, y, dict(loss_type=loss_type, feat_valid=fv))
    assert [c[:2] for c in card.calls] == [('fwd', loss_type),
                                           ('bwd', loss_type)]
    assert card.calls[0][2] is True and card.calls[1][2:] == (True, True)


@pytest.mark.parametrize('loss_type', ['cosine', 'l2', 'l1'])
def test_each_loss_type_takes_the_plain_chain_on_the_cpu(loss_type):
    reset_launches()
    x, y = _inputs(22, n=2, h=6, w=6, c=16)
    xt = torch.tensor(x, requires_grad=True)
    TC.contextual_loss(xt, torch.tensor(y), loss_type=loss_type).backward()
    assert xt.grad is not None
    assert not any(v for k, v in launch_counts().items()
                   if k.startswith('cx_chain'))


def test_the_forward_keeps_s_only_when_a_gradient_is_wanted(monkeypatch):
    """s (the (N, P, Q) scratch) is kept for the backward only when x or y
    needs a gradient and grad mode is on: the search's eval (no_grad)
    keeps nothing; a fit that wants dxn alone gets no dyn product."""
    card = _FakeCard(monkeypatch)
    x, y = (torch.as_tensor(t) for t in _inputs(23, n=2, h=6, w=6))
    xn, yn = TC.normalized_features(x, y)
    cx_chain.cx_colmax(xn, yn, 0.5)
    with torch.no_grad():
        cx_chain.cx_colmax(xn.requires_grad_(), yn, 0.5)
    z = cx_chain.cx_colmax(xn, yn, 0.5)
    assert [c[2] for c in card.calls] == [False, False, True]
    z.sum().backward()
    assert card.calls[-1] == ('bwd', 'cosine', True, False)
    assert xn.grad is not None


def test_card_forms_check_their_inputs(monkeypatch):
    _FakeCard(monkeypatch)
    x = torch.zeros(2, 9, 16)
    with pytest.raises(ValueError):   # C a multiple of 32
        cx_chain.cx_colmax_l2(x, x, 0.5)
    with pytest.raises(ValueError):   # l1 takes the (N, P) sums
        cx_chain.cx_colmax_l1(x, x, 0.5)
    with pytest.raises(ValueError):   # the mask needs P = Q
        cx_chain.cx_colmax_l1(torch.zeros(2, 9), torch.zeros(2, 8), 0.5,
                              torch.ones(2, 9))
    rows = torch.zeros(2 * 9 * 32 + 1)[1:].view(2, 9, 32)
    with pytest.raises(ValueError):   # 16-byte loads need aligned rows
        cx_chain.cx_colmax(rows, torch.zeros(2, 9, 32), 0.5)


def _normal_inputs(seed, n=3, h=10, w=10, c=32):
    """Independent normal x and y, as tests/test_torch_functions.py makes
    them for the l1 and l2 forms: the relative distance divides by a row's
    least distance, which x near y (_inputs) makes small enough that the
    two packages' sums in their own order differ by 1e-3 there."""
    rng = np.random.RandomState(seed)
    return (rng.randn(n, h, w, c).astype(np.float32),
            rng.randn(n, h, w, c).astype(np.float32))


@pytest.mark.parametrize('loss_type', ['l1', 'l2'])
@pytest.mark.parametrize('masked', [False, True])
def test_l1_l2_forms_match_npp_tpu(loss_type, masked):
    """The l1 and l2 forms' plain chains (cx_colmax_l1_plain on the
    channel sums, cx_colmax_l2_plain on the raw rows) against npp_tpu's
    contextual_loss, value and gradients in x and y; masked with one
    sample all masked. l1 on 6 x 6 maps, as test_torch_functions.py's 5 x 6:
    its distance is a difference of two channel sums, which the packages
    add in their own order, and the relative distance divides that
    rounding by a row's least distance, which shrinks as the map grows."""
    hw = 6 if loss_type == 'l1' else 8
    x, y = _normal_inputs(31 if loss_type == 'l1' else 32, n=3, h=hw, w=hw,
                          c=16)
    kw = dict(loss_type=loss_type)
    if masked:
        kw['feat_valid'] = _mask(33, 3, hw, hw, all_masked=2)
    _compare(x, y, kw)
