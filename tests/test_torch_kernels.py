"""The port's kernel wrappers. On the CPU a wrapper takes its plain version
and launches nothing; the tests marked `cuda` hold each kernel to its plain
version on the card, and skip inside the test without one. This file
imports no JAX, so on the card's machine it runs without tests/conftest.py:
`python -m pytest --noconftest -m cuda tests/test_torch_kernels.py`."""
import numpy as np
import pytest
import torch

from npp_tpu_torch.kernels import cx_chain, launch_counts, periodic_embed, \
    reset_launches
from npp_tpu_torch.kernels import robust_rho as rr
from npp_tpu_torch.kernels import snake

OFFSETS = (0.0, -1.0, 1.0, 0.5, -0.5)


def _embed_args(device, n=300, seed=0):
    gen = torch.Generator().manual_seed(seed)
    coords = torch.stack([torch.randint(0, 96, (n,), generator=gen),
                          torch.randint(0, 128, (n,), generator=gen)],
                         -1).float()
    angles = torch.tensor([[90.0, 180.0], [10.0, 100.0], [45.0, 135.0]])
    periods = torch.tensor([[24.0, 28.0], [12.0, 14.5], [48.0, 56.0]])
    bands = torch.randn(10, generator=gen) * 10
    return tuple(t.to(device) for t in (coords, angles, periods, bands)) + (
        (1.0,), OFFSETS, (0.0,), (96, 128))


def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def test_wrappers_take_the_plain_version_on_the_cpu():
    reset_launches()
    args = _embed_args('cpu')
    np.testing.assert_array_equal(
        periodic_embed.periodic_embed(*args).numpy(),
        periodic_embed.periodic_embed_plain(*args).numpy())
    h, b = torch.randn(7, 5), torch.randn(5)
    assert torch.equal(snake.bias_snake(h, b), snake.bias_snake_plain(h, b))
    x, a, s, w = torch.randn(9, 4), torch.rand(4) + 0.5, torch.rand(4) + 0.1, \
        torch.rand(4)
    assert torch.equal(rr.rho_rows(x, a, s, w), rr.rho_rows_plain(x, a, s, w))
    assert not any(launch_counts().values())


def test_k1_bf16_on_the_cpu_is_the_f32_plain_version_rounded():
    """bfloat16 output: the f32 function rounded to nearest even, as
    npp_tpu's `.astype(jnp.bfloat16)` of its table."""
    reset_launches()
    args = _embed_args('cpu')
    got = periodic_embed.periodic_embed(*args, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, periodic_embed.periodic_embed_plain(*args).to(
        torch.bfloat16))
    assert not any(launch_counts().values())
    with pytest.raises(ValueError):
        periodic_embed.periodic_embed(*args, out_dtype=torch.float16)


# alpha over the adaptive range, densest at its ends, where the direct
# form of the alpha derivative cancels in f32
ALPHAS = (0.001, 0.01, 0.1, 0.3, 0.5, 0.9, 0.999, 1.0, 1.2, 1.5, 1.8, 1.9,
          1.99, 1.999)


@pytest.mark.parametrize('scale', [0.01, 0.05, 0.5])
def test_k4_backward_arithmetic_matches_float64(scale):
    """rho_bwd_plain (the backward kernel's arithmetic, in f32) against
    float64 autograd of rho_rows_plain, element by element: each element
    is its own channel, with alpha exactly each of ALPHAS and x ~ N(0,
    0.2^2). Per output and alpha, its error relative to the largest
    float64 magnitude is no worse than f32 autograd's own, or 1e-5 (a few
    f32 ulp). f32 autograd's alpha gradient is off by 1e-2 to 2 at alpha
    0.001 and by 2e-5 to 5e-5 at 1.999."""
    rng = np.random.RandomState(int(scale * 100))
    n = 2048
    x = torch.tensor(rng.randn(1, n) * 0.2, dtype=torch.float32)
    g = torch.ones(1)
    w = torch.ones(n)
    s = torch.full((n,), scale)
    for alpha in ALPHAS:
        a = torch.full((n,), alpha)
        got = rr.rho_bwd_plain(g, x, a, s, w)
        grads = []
        for dt in (torch.float32, torch.float64):
            ins = [t.to(dt, copy=True).requires_grad_() for t in (x, a, s)]
            rr.rho_rows_plain(*ins, w.to(dt)).backward(g.to(dt))
            grads.append([t.grad for t in ins])
        for name, mine, p32, ref in zip(('dx', 'dalpha', 'dscale'), got,
                                        *grads):
            top = float(ref.abs().max())
            k_err = float((mine.double() - ref).abs().max()) / top
            p_err = float((p32.double() - ref).abs().max()) / top
            assert k_err <= max(p_err, 1e-5), (name, alpha, k_err, p_err)


def _k4_segment(gen, m, c, alpha=None):
    """x ~ N(0, 0.2^2) (m, c); alpha spread over (0.001, 1.999), or every
    channel at `alpha`; scale, w (c,)."""
    a = 0.001 + 1.998 * torch.rand(c, generator=gen) if alpha is None \
        else torch.full((c,), alpha)
    return (torch.randn(m, c, generator=gen) * 0.2, a,
            0.01 + torch.rand(c, generator=gen), torch.rand(c, generator=gen))


def test_k4_group_on_the_cpu_is_the_plain_version_per_segment():
    """rho_rows_group on CPU tensors: each segment's rows and its x, alpha
    and scale gradients are rho_rows_plain's, bit for bit; nothing
    launches; more than MAX_SEGMENTS segments raise."""
    reset_launches()
    gen = torch.Generator().manual_seed(1)
    segs = [_k4_segment(gen, m, c) for m, c in ((40, 64), (10, 128), (9, 3))]
    gs = [torch.randn(seg[0].shape[0], generator=gen) for seg in segs]
    ins_g = [[t.clone().requires_grad_() for t in seg[:3]] for seg in segs]
    ins_p = [[t.clone().requires_grad_() for t in seg[:3]] for seg in segs]
    rows_g = rr.rho_rows_group(*zip(*[(*i, seg[3])
                                      for i, seg in zip(ins_g, segs)]))
    rows_p = [rr.rho_rows_plain(*i, seg[3]) for i, seg in zip(ins_p, segs)]
    torch.autograd.backward(rows_g, gs)
    torch.autograd.backward(rows_p, gs)
    for got, want in zip(rows_g, rows_p):
        assert torch.equal(got, want)
    for ig, ip in zip(ins_g, ins_p):
        for a, b in zip(ig, ip):
            assert torch.equal(a.grad, b.grad)
    assert not any(launch_counts().values())
    with pytest.raises(ValueError):
        rr.rho_rows_group(*[[t] * (rr.MAX_SEGMENTS + 1) for t in segs[0]])


def test_embed_dims_match_the_config():
    from npp_tpu_torch.config import (CompletionConfig, nerf_embed_dim,
                                      periodic_embed_dim)
    cfg = CompletionConfig()
    p, d = periodic_embed.embed_dims(cfg.multires, len(cfg.freq_scales),
                                     len(cfg.freq_offsets),
                                     len(cfg.angle_offsets))
    assert p == periodic_embed_dim(cfg, include_input=True) == 22
    assert d == p * nerf_embed_dim(cfg, 1) == 462


@pytest.mark.cuda
def test_k1_matches_plain_on_the_card():
    """Same f32 operations in the same order (no FMA contraction, floored
    modulo, precise sinf/cosf): within 1e-5 absolute."""
    dev = _card()
    for bands in (True, False):
        args = list(_embed_args(dev, n=5000))
        if not bands:
            args[3] = None
        before = launch_counts()['periodic_embed']
        got = periodic_embed.periodic_embed(*args)
        want = periodic_embed.periodic_embed_plain(*args)
        torch.cuda.synchronize()
        assert launch_counts()['periodic_embed'] == before + 1
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_k1_bf16_matches_plain_on_the_card():
    """bfloat16 output: the f32 kernel's output rounded to nearest even,
    bit for bit, so within one bf16 ulp of the plain f32 result rounded to
    bf16, plus K1's f32 tolerance of 1e-5 near zero, where the ulp is
    tiny."""
    dev = _card()
    args = _embed_args(dev, n=5000)
    before = launch_counts()['periodic_embed_bf16']
    got = periodic_embed.periodic_embed(*args, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert launch_counts()['periodic_embed_bf16'] == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, periodic_embed.periodic_embed(*args).to(
        torch.bfloat16))
    got = got.float()
    want = periodic_embed.periodic_embed_plain(*args).to(
        torch.bfloat16).float()
    top = torch.maximum(got.abs(), want.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    assert bool(((got - want).abs() <= ulp + 1e-5).all())


@pytest.mark.cuda
def test_k1_backward_matches_plain_on_the_card():
    """The coordinate gradient of the f32 embedding at non-integer
    coordinates, with and without Fourier bands: K1's backward kernel
    (one launch per backward) against autograd through the plain version,
    both held to float64 (the phases are rounded in f32 in both)."""
    dev = _card()
    gen = torch.Generator().manual_seed(1)
    for bands in (True, False):
        coords, angles, periods, bnd, *cfg = _embed_args(dev, n=5000)
        coords = coords + torch.rand(coords.shape, generator=gen).to(dev)
        consts = (angles, periods) + ((bnd,) if bands else ())

        def call(f):
            return lambda c, a, p, *b: f(c, a, p, b[0] if b else None, *cfg)
        n_out = call(periodic_embed.periodic_embed_plain)(coords,
                                                          *consts).shape[1]
        g = torch.randn(5000, n_out, generator=gen).to(dev)
        before = launch_counts()['periodic_embed_bwd']
        _assert_no_worse_than_plain(call(periodic_embed.periodic_embed),
                                    call(periodic_embed.periodic_embed_plain),
                                    (coords,), consts, g)
        assert launch_counts()['periodic_embed_bwd'] == before + 1


def _assert_no_worse_than_plain(fn, plain, inputs, consts, g):
    """Run the kernel's wrapper, its plain version in f32 and the plain
    version in float64 on the same inputs, forward and backward (fn may
    return a list of outputs, g then a list of their gradients). Sums run
    in another order in the kernel, and some terms cancel in f32 in both,
    so both are held to the float64 result: the kernel's error, relative
    to each output's largest magnitude, at most twice the f32 plain
    version's own, or 1e-5."""
    outs = []
    for f, dt in ((fn, torch.float32), (plain, torch.float32),
                  (plain, torch.float64)):
        ins = [t.to(dt, copy=True).requires_grad_() for t in inputs]
        y = f(*ins, *[c.to(dt) for c in consts])
        ys, gs = (y, g) if isinstance(y, list) else ([y], [g])
        torch.autograd.backward(ys, [t.to(dt) for t in gs])
        outs.append([t.detach() for t in ys] + [t.grad for t in ins])
    for i, (got, p32, ref) in enumerate(zip(*outs)):   # output, grads
        scale = float(ref.abs().max())
        k_err = float((got.double() - ref).abs().max()) / scale
        p_err = float((p32.double() - ref).abs().max()) / scale
        assert k_err <= max(2 * p_err, 1e-5), (i, k_err, p_err)


@pytest.mark.cuda
@pytest.mark.parametrize('batch,n', [(None, 512), (None, 256), (None, 3),
                                     (9, 256), (9, 128), (1, 64)])
def test_k2_forward_and_backward_match_plain_on_the_card(batch, n):
    """(4099, n) with a bias (n,), or a batch (B, 1031, n) with a bias per
    batch (B, n), the search's stacked layers."""
    dev = _card()
    gen = torch.Generator().manual_seed(n)
    lead = () if batch is None else (batch,)
    m = 4099 if batch is None else 1031
    h = torch.randn(*lead, m, n, generator=gen).to(dev)
    b = torch.randn(*lead, n, generator=gen).to(dev)
    g = torch.randn(*lead, m, n, generator=gen).to(dev)
    _assert_no_worse_than_plain(snake.bias_snake, snake.bias_snake_plain,
                                (h, b), (), g)


@pytest.mark.cuda
@pytest.mark.parametrize('m,c', [(8192, 3), (6000, 64), (1500, 512)])
def test_k4_forward_and_backward_match_plain_on_the_card(m, c):
    """Alpha over the whole adaptive range (0.001, 1.999)."""
    dev = _card()
    gen = torch.Generator().manual_seed(c)
    x = (torch.randn(m, c, generator=gen) * 0.2).to(dev)
    alpha = (0.001 + 1.998 * torch.rand(c, generator=gen)).to(dev)
    scale = (0.01 + torch.rand(c, generator=gen)).to(dev)
    w = torch.rand(c, generator=gen).to(dev)
    g = torch.randn(m, generator=gen).to(dev)
    _assert_no_worse_than_plain(rr.rho_rows, rr.rho_rows_plain,
                                (x, alpha, scale), (w,), g)


# the main path's K4 shapes: the pixel loss, then each LPIPS layer at six
# 160x160 patches; the five LPIPS layers also as one grouped launch
K4_SHAPES = [(8192, 3), (153600, 64), (38400, 128), (9600, 256),
             (2400, 512), (600, 512)]
# the search's lockstep fit: N_rand 2048 rows, 9 candidates x 3 channels
K4_SEARCH = (2048, 27)
# the remapping's adaptive style loss: the three layers' flattened Gram
# residuals over P*K = 6 patches (the wide-row paths), alone and grouped
K4_STYLE = [(6, 4096), (6, 16384), (6, 65536)]
K4_CASES = [[shape] for shape in K4_SHAPES] + [K4_SHAPES[1:]] + \
    [[K4_SEARCH]] + [[K4_STYLE[-1]], K4_STYLE]


def _group(n, fn):
    """fn over n segments, taking (x..., alpha..., scale..., w...)."""
    return lambda *t: fn(t[:n], t[n:2 * n], t[2 * n:3 * n], t[3 * n:])


@pytest.mark.cuda
@pytest.mark.parametrize('shapes', K4_CASES,
                         ids=lambda s: '+'.join(f'{m}x{c}' for m, c in s))
@pytest.mark.parametrize('alpha', [0.001, 1.0, 1.999])
def test_k4_at_main_path_shapes_on_the_card(shapes, alpha):
    """Every channel at alpha exactly 0.001, 1.0 or 1.999: the ends of the
    adaptive range and the switch between the backward's two forms. Each
    shape alone, and the five LPIPS layers in one forward launch (each
    segment's rows and gradients held to the plain version)."""
    dev = _card()
    gen = torch.Generator().manual_seed(sum(m + c for m, c in shapes))
    segs = [[t.to(dev) for t in _k4_segment(gen, m, c, alpha)]
            for m, c in shapes]
    g = [torch.randn(m, generator=gen).to(dev) for m, _ in shapes]
    n = len(shapes)
    key = 'robust_rho_fwd' if n == 1 else 'robust_rho_fwd_group'
    before = launch_counts().get(key, 0)
    _assert_no_worse_than_plain(_group(n, rr.rho_rows_group),
                                _group(n, rr.rho_rows_group_plain),
                                [seg[i] for i in range(3) for seg in segs],
                                [seg[3] for seg in segs], g)
    assert launch_counts()[key] == before + 1


def _k3_rows(gen, n, p, c, dup=0, dev='cuda'):
    """Normalised rows as the fits make them: relu features y, x near y,
    the `dup` positions from p // 2 repeating the first `dup` exactly in
    both (equal rows and columns), shifted by y's mean."""
    y = torch.relu(torch.randn(n, p, c, generator=gen))
    x = y + 0.5 * torch.randn(n, p, c, generator=gen)
    for t in (x, y):
        t[:, p // 2:p // 2 + dup] = t[:, :dup]
    mu = y.mean((0, 1), keepdim=True)
    xn, yn = (torch.nn.functional.normalize(t - mu, dim=-1, eps=1e-12)
              for t in (x, y))
    return xn.to(dev), yn.to(dev)


def _k3_run(fn, x, y, fv, g, tf32):
    """z and its gradients in x and y of fn, with TF32 on or off."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        a, b = (t.clone().requires_grad_() for t in (x, y))
        z = fn(a, b, 0.5, fv)
        (z * g).sum().backward()
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return z.detach(), a.grad, b.grad


def _k3_assert_close(fn, plain, x, y, fv, g, tf32, bar=None):
    """fn against plain on the same card in the same precision: within
    1e-4 of the largest value in f32, 2e-3 with TF32 (the two products
    round differently in TF32)."""
    bar = bar or (2e-3 if tf32 else 1e-4)
    for got, want in zip(_k3_run(fn, x, y, fv, g, tf32),
                         _k3_run(plain, x, y, fv, g, tf32)):
        assert torch.isfinite(got).all()
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= bar, err


@pytest.mark.cuda
@pytest.mark.parametrize('tf32', [False, True], ids=['f32', 'tf32'])
@pytest.mark.parametrize('case', ['ragged', 'ties', 'masked', 'p784',
                                  'p1601'])
def test_k3_forward_and_backward_match_plain_on_the_card(case, tf32):
    """z and its gradients in xn and yn against the plain chain.
    'ties' has exact duplicate rows and columns (tied maxima and minima),
    'masked' one sample with every position masked too, 'p784' and
    'p1601' ragged edges of the 128-row product tiles and of the 32-wide
    pitches at the paths' widths."""
    dev = _card()
    gen = torch.Generator().manual_seed(7)
    n, p = {'ragged': (2, 100), 'p784': (6, 784),
            'p1601': (2, 1601)}.get(case, (3, 144))
    xn, yn = _k3_rows(gen, n, p, 256,
                      dup=40 if case in ('ties', 'masked') else 0)
    fv = None
    if case == 'masked':
        fv = (torch.rand(n, p, generator=gen) > 0.3).float().to(dev)
        fv[1] = 0.0
    g = (torch.rand(n, p, generator=gen) + 0.5).to(dev)
    before = launch_counts().get('cx_chain_bwd', 0)
    _k3_assert_close(cx_chain.cx_colmax, cx_chain.cx_colmax_plain, xn, yn,
                     fv, g, tf32)
    assert launch_counts()['cx_chain_bwd'] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize('c', [64, 128, 512])
def test_k3_other_channel_counts_match_plain_on_the_card(c):
    """C = 64, 128 (narrower than a product tile's 128 columns of dxn) and
    512 (the widest K3 takes), in f32 and with TF32."""
    dev = _card()
    gen = torch.Generator().manual_seed(c)
    xn, yn = _k3_rows(gen, 2, 200, c)
    g = (torch.rand(2, 200, generator=gen) + 0.5).to(dev)
    for tf32 in (False, True):
        _k3_assert_close(cx_chain.cx_colmax, cx_chain.cx_colmax_plain, xn,
                         yn, None, g, tf32)


@pytest.mark.cuda
@pytest.mark.parametrize('tf32', [False, True], ids=['f32', 'tf32'])
def test_k3_two_launches_are_bit_equal_on_the_card(tf32):
    """No atomics: z and both gradients repeat bit for bit, also with ties
    and a mask."""
    dev = _card()
    gen = torch.Generator().manual_seed(11)
    xn, yn = _k3_rows(gen, 6, 300, 256, dup=30)
    fv = (torch.rand(6, 300, generator=gen) > 0.3).float().to(dev)
    g = (torch.rand(6, 300, generator=gen) + 0.5).to(dev)
    for mask in (None, fv):
        one = _k3_run(cx_chain.cx_colmax, xn, yn, mask, g, tf32)
        two = _k3_run(cx_chain.cx_colmax, xn, yn, mask, g, tf32)
        for a, b in zip(one, two):
            assert torch.equal(a, b)


def _k3_raw(gen, n, p, c):
    """Raw relu features for the l2 and l1 forms: y, and x near y."""
    y = torch.relu(torch.randn(n, p, c, generator=gen))
    return (y + 0.5 * torch.randn(n, p, c, generator=gen)).cuda(), y.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize('masked', [False, True])
def test_k3_l2_form_matches_plain_on_the_card(masked):
    """The l2 form (s from the product, d from the rows' norms, the norm
    terms of the gradient) against its plain chain in f32."""
    _card()
    gen = torch.Generator().manual_seed(13)
    x, y = _k3_raw(gen, 3, 150, 256)
    fv = (torch.rand(3, 150, generator=gen) > 0.3).float().cuda() \
        if masked else None
    g = (torch.rand(3, 150, generator=gen) + 0.5).cuda()
    before = launch_counts().get('cx_chain_l2_bwd', 0)
    _k3_assert_close(cx_chain.cx_colmax_l2, cx_chain.cx_colmax_l2_plain, x,
                     y, fv, g, False)
    assert launch_counts()['cx_chain_l2_bwd'] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize('masked', [False, True])
def test_k3_l1_form_matches_plain_on_the_card(masked):
    """The l1 form on the channel sums (no product), with TF32 on too: its
    chain has no product, so both run in f32."""
    _card()
    gen = torch.Generator().manual_seed(17)
    x, y = _k3_raw(gen, 3, 150, 64)
    xs, ys = x.sum(-1), y.sum(-1)
    fv = (torch.rand(3, 150, generator=gen) > 0.3).float().cuda() \
        if masked else None
    g = (torch.rand(3, 150, generator=gen) + 0.5).cuda()
    before = launch_counts().get('cx_chain_l1_bwd', 0)
    for tf32 in (False, True):
        _k3_assert_close(cx_chain.cx_colmax_l1, cx_chain.cx_colmax_l1_plain,
                         xs, ys, fv, g, tf32, bar=1e-4)
    assert launch_counts()['cx_chain_l1_bwd'] == before + 2
