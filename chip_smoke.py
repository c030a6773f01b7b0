"""Drive the PyTorch port on one CUDA card and hold its kernels to their
plain versions.

    python3 chip_smoke.py            (from the repository root, one card)

Phases, in order; any failure exits non-zero:
 1. device: the card's name and power limit;
 2. build: K1 (csrc/periodic_embed.cu, forward and backward), K4's
    forward and backward (csrc/robust_rho_fwd.cu, csrc/robust_rho_bwd.cu)
    and K3 (csrc/cx_chain.cu, the CX chain both ways), one nvcc each,
    printing `-Xptxas -v`, K3's PTX (its wgmma.mma_async count, which must
    not be 0), and the host libraries with g++
    (the segmentation's graph cut, csrc/graphcut.cpp, and the seam
    composite's Navier-Stokes inpainting, csrc/inpaint_ns.cpp), all
    started together;
 3. kernels, with TF32 off: each kernel's wrapper against its plain
    PyTorch version on the card at the main paths' shapes (K1 in f32 and
    bf16, and its backward in the coordinates at 59,392 rows, and in f32 at
    the segmentation canvas's 81,920 rows; K2 forward and backward, at the
    segmentation step's 16,384 x 512, and batched at the search's 9 x 2048
    x 256 and 9 x 2048 x 128; K4 at the search's 2048 x 27 both ways with
    every alpha; K4's forward at the pixel loss's and the evaluation's
    shapes and as one grouped launch over the five LPIPS layers, with
    alpha spread and at exactly 0.001, 1.0 and 1.999, and within 1e-6 of
    float64; K4's backward at each shape; K4's wide rows at the style
    loss's 6 x 4,096, 6 x 16,384 and 6 x 65,536, the forward as one grouped
    launch, both ways at every alpha), timed by CUDA-graph replay (device
    time) and by eager launches; then one completion step, one with the
    warp field, one remapping step and one segmentation step, each with
    injected inputs and matmul_precision='float32' on the card against the
    same step on the CPU (plain versions); the blur map of the remapping
    example with its eigenvalues on the card against the CPU; SLIC of the
    segmentation example on the card twice (the same labels) and against
    the CPU (>= 99.9% of the labels); the inpainting library against cv2's
    outputs (tests/fixtures/torch_inpaint_ns_cv2.npz, every pixel); K4 at
    LPIPS-squeeze's seven layers (the forward as one grouped launch, the
    backward at each shape) and LPIPS-squeeze robust, value and gradients,
    card against CPU; K3 at the completion's 6 x 1,600 x 1,600 x 256, the
    batched fit's 18 x 1,600, the 64^2 patches' 6 x 256 (remapping and
    segmentation) both ways and the search eval's 3 x 12,288 masked
    forward: z within 1e-4 of float64 and at most twice the plain f32
    chain's distance, the gradients within 1e-3 of the largest float64
    value, and on inputs with exact duplicate rows and columns (ties) and
    an all-masked sample the plain version's gradients within 1e-3; timed
    as the paths run it (the fits' shapes with TF32, beside f32), with
    each pass's device time, its scratch bytes and peak memory; K3's l2
    and l1 forms at 6 x 256 and 6 x 1,600 against their plain chains and
    float64 with the same bars, and with TF32 against the plain chain
    (also TF32) within 2e-3. Device times are cold
    (a 128 MB write evicts the L2 before each replayed call), with the
    warm reading beside them;
 4. TF32: the gradients of the CX (through K3 both ways), LPIPS-robust
    and adaptive style terms,
    of one default completion step and of one remapping step under the
    default matmul_precision ('bfloat16': TF32 on) against 'float32', at
    the flagship patch scales, and of the LPIPS-robust and style terms
    with the feature_dtype='bfloat16' towers that build_components makes
    (their activations must be bf16) against the f32 towers in full f32;
    cosine >= 0.99, and below 1 for the bf16 towers;
 5. main path: `run_completion` on the 384x512 synthetic example at the
    default CompletionConfig (TF32 in the steps and the render), 21
    iterations (two blocks of 10 steps, evals at 10 and 20, the final
    render, composite and val_lpips), with every launch count set to 0
    just before and read just after (K3 both ways on every fit of phases
    5-9 and 11-13: at 6 x 1,600 x 1,600 x 256 on the completion's 160^2
    patches, 18 x 1,600 batched, 6 x 256 on the 64^2 patches of 7 and 12;
    K3's forward in the evals of 10 and 14);
 6. bf16-table path: the same fit with embed_table='bfloat16', 11
    iterations (one block, one eval), counted the same way;
 7. remapping path: `run_remapping` on the synthetic remapping example
    (the flagship image blurred inside an ellipse; its blur map on the
    card) at the default RemappingConfig widths, 21 iterations with evals
    at 10 and 20, the final LPIPS and the collapse guard, counted the same
    way (K4's grouped style launch and its backward once per step);
 8. held-out path: the completion with comp_heldout=2 and
    comp_snapshot='best', 11 iterations with milestones at 5 and 10;
 9. warp path: the completion with warp_field=True, 11 iterations: K1 on
    the fly on warped coordinates (no table) and its backward every step;
    then the seam path: comp_seam='residual', 11 iterations, the composite
    the seam-corrected one (the inpainting's host time per call). Every
    completion path's final outputs must hold pred_rgb_img_comp_seam,
    val_psnr_seam and val_lpips_seam (made at comp_seam='none' too);
10. search path: `run_search` at the default SearchConfig on the same
    image without its lattices (detection with its FFT grid on the card,
    the 300-step lockstep fit of 9 candidates through K2 batched and one
    K4 launch each way per step, the LPIPS + CX eval), counted the same
    way; before it, in phase 3, detection with the grid on the card
    against the CPU (equal up to proven ties) and one lockstep step on the
    card against the CPU in full f32;
11. search-chained path: the completion fit of phase 5 for 11 iterations
    on the search's top-3 lattices (the patch size they give), counted the
    same way;
12. segmentation path: `run_segmentation` on the 256x320 synthetic
    segmentation example (utils/synthetic.py::synthetic_segment_data: the
    coarse SLIC on the card + GMM + graph cut, the fit through K1's table,
    K2 and K4, the spatial LPIPS-alex refinement) at the default
    SegmentationConfig widths, 21 iterations with refinements at 10 and
    20, counted the same way; its wall, peak memory and the IoU of the
    coarse and refined masks against the example's ground truth;
13. batched paths (parallel/runner.py::fit_images): three flagship
    images (synthetic seeds 0-2) at the default CompletionConfig, 21
    iterations (K1's batched forward every step, K2 at (3, 59,392, 512),
    K4's pixel loss at 8,192 x 9), its steady block profiled beside a
    sequential fit_image of image 0; two images with
    embed_table='bfloat16' (both tables in one batched K1 launch); three
    with the warp field (K1's batched backward every step); in phase 3,
    K1's batched entries against their plain versions and float64, K2 and
    K4 at the batched and suite shapes, and one batched step of three
    images against the three single steps on the card;
14. suite search: run_search_suite on three synthetic_search_data images
    (K2 at (27, 2,048, 256 / 128), K4 at 2,048 x 81), whose top-3 must
    equal each image's sequential run_search, run twice; in full f32 also
    its distances (within the two runs' spread, or 1e-3 relative);
15. entry points from files: the flagship example written as PNGs by
    the port's writer, `cli search` (with its grid pictures), `cli
    complete --N_iters 11` on its output, scripts/torch_run_suite.py
    --batched --batched-search on three examples, and --preset quality
    --iters-scale 0.0055 on one, in subprocesses;
16. squeeze path: 10 Adam steps under LPIPS-squeeze robust at the
    completion's robust batch (six 160x160 patches), counted the same way;
    then the weight sources: a .pth found through NPP_TPU_TORCH_WEIGHTS
    and the same weights as an npz through NPP_TPU_WEIGHTS_DIR, the same
    LPIPS-alex value;
17. multi-card path (parallel/{mesh,multihost,launch}.py), ranks started
    by launch.spawn, each on its own card (resolve_device(None) must give
    it): (a) NCCL at torch.cuda.device_count() ranks: fit_images on
    phase 13's three images over the 'images' axis, 21 iterations, each
    image's parameters within the spread of phase 13's two unsharded runs
    (or 1e-4 of each tensor's largest value), and make_sharded_render of
    image 0 at 384x512 equal to make_render's (bit for bit, or within
    1e-6); (b) two gloo ranks sharing the card: the same fit (three
    images padded to four, two a rank) and render, each image held the
    same way to an unsharded fit of its rank's block ([0, 1], [2, 2]:
    stacks of other sizes round otherwise, which the CX term carries far
    in 20 steps; the distance from the three-image runs is reported
    beside an unsharded [2, 2] fit's), rank_proposals of the flagship's
    nine detected candidates over a 'candidates' axis (padded to ten) in
    full f32 within 1e-4 relative of the unsharded call in the same rank
    with the same top-3, and run_search_suite of phase 14's three images
    over an 'images' axis with phase 14's top-3; (c) torch.distributed.run
    --nproc-per-node=<card count> scripts/torch_run_suite.py --batched
    --batched-search on phase 15's three examples, whose summary.json
    must give phase 15's records' keys and top-3. Per rank: the wall,
    the steady ms/step, the peak memory and K1's to K4's launches,
    each count set to 0 just before and read just after;
18. bench_torch.py with NPP_BENCH_BATCHED=0 and NPP_BENCH_LATENCY=0 in a
    subprocess: its last line holds bench.py's keys, 0 < mfu < 1, value > 0
    and a finite vs_baseline, and its primary launched K1 to K4;
19. scripts/torch_eval_remapping.py --n-synth 1 --iters-scale 0.05 in a
    subprocess: its record holds scripts/eval_remapping.py's keys with
    finite values and that script's classical baselines, and the summary
    line follows;
20. one JSON line of kernels (with the search's, the remapping's, the
    warp's, the segmentation's and the batched paths' shapes and
    launches, the multi-card ranks' launches by kernel, K3's launches by
    path), the paths'
    walls and metrics, the nvidia-smi line, and the final
    {"ok": true, "device": {...}} line.
"""
import concurrent.futures
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# the card's published peaks (npp_tpu_torch/device.py::card_peaks), set
# by main() from the card's name: every bound below is taken against them
PEAKS = None


def fail(msg):
    print(f'[chip_smoke] FAIL: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(f'[chip_smoke] {msg}', flush=True)


def bound_ms(n_bytes, n_ops):
    """The least time for the work: bytes over the memory rate or f32
    operations over the f32 peak, whichever is larger."""
    t_bytes = n_bytes / PEAKS.hbm_bytes_per_s
    t_ops = n_ops / PEAKS.f32
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations')


L2_FLUSH_FLOATS = 32 << 20   # 128 MB, more than twice the H100's 50 MB L2


def _replay_ms(body, iters, reps=5):
    """Median ms of `reps` replays of one CUDA graph of `iters` calls of
    `body`, each between two CUDA events."""
    import torch
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            body()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return sorted(times)[reps // 2]


def time_ms(fn, iters=20, warmup=3, cold=True):
    """Device ms per call: after `warmup` eager calls, `iters` calls are
    captured in one CUDA graph and replayed between two CUDA events (the
    median of five replays), so the host's share of a launch (Python,
    ctypes, Triton's launcher) is left out; eager_ms keeps it. cold (the
    default): each call follows a 128 MB write that evicts the L2, so a
    kernel whose working set fits in the 50 MB L2 cannot read it from
    there on the next replayed call (which read above the HBM bound), and
    the same writes' own time, replayed alone, is subtracted. cold=False:
    back-to-back calls, the warm reading."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if not cold:
        return _replay_ms(fn, iters) / iters
    buf = torch.empty(L2_FLUSH_FLOATS, device='cuda')

    def flushed():
        buf.zero_()
        fn()

    ms = (_replay_ms(flushed, iters) - _replay_ms(buf.zero_, iters)) / iters
    del buf
    return ms


def device_times(fn, **kw):
    """{'ms': the cold device time, 'warm_ms': the warm one} of time_ms."""
    return dict(ms=time_ms(fn, **kw), warm_ms=time_ms(fn, cold=False, **kw))


def eager_ms(fn, iters=20, warmup=3):
    """ms per call of `iters` eager calls back to back between two CUDA
    events: the device time, or the host's time per launch where that is
    longer."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def judge(pairs, floor=1e-5):
    """Hold a kernel to its plain version. pairs: (kernel output, plain
    version in float32, plain version in float64 on the same inputs).
    Returns the kernel's largest absolute difference from the f32 plain
    version, and its error and the f32 plain version's own error against
    the float64 one, both relative to the largest float64 magnitude. The
    kernel passes when its error is at most twice the plain version's own,
    or `floor` (a few f32 ulp at the largest magnitude); `passed` says
    whether it did."""
    abs_err = k_err = p_err = 0.0
    for got, p32, p64 in pairs:
        got, p32, p64 = (t.detach().double() for t in (got, p32, p64))
        scale = max(float(p64.abs().max()), 1e-30)
        abs_err = max(abs_err, float((got - p32).abs().max()))
        k_err = max(k_err, float((got - p64).abs().max()) / scale)
        p_err = max(p_err, float((p32 - p64).abs().max()) / scale)
    tol = max(2 * p_err, floor)
    return dict(max_abs_err=abs_err, rel_err_vs_f64=k_err,
                plain_rel_err_vs_f64=p_err, tol=tol, passed=k_err <= tol)


def merge(a, b):
    """Worst of two judge() results."""
    return {k: (a[k] and b[k]) if k == 'passed' else max(a[k], b[k])
            for k in a}


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this script needs a card')
    if not os.path.isdir(os.path.join(ROOT, 'npp_tpu_torch')):
        fail(f'no npp_tpu_torch package beside {__file__}: run it from a '
             'checkout of the repository')
    sys.path.insert(0, ROOT)
    from npp_tpu_torch.device import smi_line
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f'device {name}; torch {torch.__version__}, CUDA {torch.version.cuda}')
    return name, smi


CUDA_SOURCES = ('periodic_embed', 'robust_rho_fwd', 'robust_rho_bwd',
                'cx_chain')
HOST_SOURCES = ('graphcut', 'inpaint_ns')


def phase_build():
    """One nvcc per CUDA source and g++ for each host library (the graph
    cut, the inpainting), all started together."""
    from npp_tpu_torch.kernels.build import build_host_library, build_library
    t0 = time.time()
    jobs = [lambda n=n: build_library(n, ptxas_verbose=True)
            for n in CUDA_SOURCES] + \
        [lambda n=n: build_host_library(n) for n in HOST_SOURCES] + \
        [k3_wgmma_count]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        wgmma = list(pool.map(lambda job: job(), jobs))[-1]
    log(f'built {", ".join(f"csrc/{n}.cu" for n in CUDA_SOURCES)} and '
        f'{", ".join(f"csrc/{n}.cpp" for n in HOST_SOURCES)} in '
        f'{time.time() - t0:.1f} s; K3\'s PTX holds {wgmma} '
        f'wgmma.mma_async instructions')
    if wgmma <= 0:
        fail("K3's TF32 products are not on wgmma.mma_async")
    return wgmma


def bf16_ulps(got, want, floor):
    """Largest |got - want| in units of the bf16 ulp at the larger of the
    two magnitudes (2^(e - 7) for |v| in [2^e, 2^(e + 1))) plus `floor`:
    near zero the ulp is tiny and f32 rounding of the two sides (at most
    `floor`) decides."""
    import torch
    got, want = got.float(), want.float()
    top = torch.maximum(got.abs(), want.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return float(((got - want).abs() / (ulp + floor)).max())


def check_k1(gen):
    """K1 at the canvas table's shape (384*512 rows, K=3, 1386 channels),
    writing f32 and bf16. f32 is judged against the plain version in f32
    and float64. bf16 must be the f32 kernel's output rounded to nearest
    even, bit for bit, and so lie within one bf16 ulp (plus the f32
    tolerance of 1e-5 near zero) of the plain f32 result rounded to bf16."""
    import torch
    from npp_tpu_torch.kernels.periodic_embed import (periodic_embed,
                                                      periodic_embed_plain)
    from npp_tpu_torch.utils.synthetic import H, W, synthetic_data
    data = synthetic_data(0)
    dev = torch.device('cuda')
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing='ij')
    coords = torch.stack([ys, xs], -1).reshape(-1, 2).float()
    angles = torch.tensor(data.selected_angles, device=dev).float()
    periods = torch.tensor(data.selected_periods, device=dev).float()
    bands = (torch.randn(10, generator=gen) * 10).to(dev)
    args = (coords, angles, periods, bands, (1.0,),
            (0.0, -1.0, 1.0, 0.5, -0.5), (0.0,), (H, W))
    want = periodic_embed_plain(*args)
    got32 = None
    out = []
    for dtype, name in ((torch.float32, 'periodic_embed'),
                        (torch.bfloat16, 'periodic_embed_bf16')):
        got = periodic_embed(*args, out_dtype=dtype)
        torch.cuda.synchronize()
        if got.shape != (H * W, 1386) or got.dtype != dtype:
            fail(f'K1 output {tuple(got.shape)} {got.dtype}')
        if dtype == torch.float32:
            want64 = periodic_embed_plain(*[a.double() if torch.is_tensor(a)
                                            else a for a in args])
            err = judge([(got, want, want64)])
            del want64
            got32 = got
        else:
            rounded = torch.equal(got, got32.to(dtype))
            ulps = bf16_ulps(got, want.to(dtype), 1e-5)
            err = dict(max_abs_err=float((got.float() - want).abs().max()),
                       max_bf16_ulps=ulps, equals_f32_kernel_rounded=rounded,
                       passed=ulps <= 1.0 and rounded)
        del got
        n_out = H * W * 1386
        b_ms, b_by = bound_ms(coords.numel() * 4 + n_out * dtype.itemsize,
                              n_out * 20)
        out.append(dict(
            name=name, route='cuda',
            source='npp_tpu_torch/csrc/periodic_embed.cu',
            replaces='npp_tpu/nn/embedder.py:149 (TaskEmbedder.embed, '
                     'XLA-fused, and embedder.py:235 .astype(dtype) for the '
                     'table; no pl.pallas_call in the repo)',
            shape=[H * W, 1386], dtype=str(dtype).split('.')[-1], **err,
            **device_times(lambda: periodic_embed(*args, out_dtype=dtype)),
            eager_ms=eager_ms(lambda: periodic_embed(*args,
                                                     out_dtype=dtype)),
            plain_ms=time_ms(lambda: periodic_embed_plain(
                *args, out_dtype=dtype), iters=5),
            bound_ms=b_ms, bound_us=1e3 * b_ms, bound_by=b_by,
            library_ms=None))
    return out


def _k2_check(gen, shape):
    """K2 forward and backward at `shape` ((M, N), or (B, M, N) with a bias
    per batch) against the plain version in f32 and float64."""
    import torch
    from npp_tpu_torch.kernels import snake
    dev = torch.device('cuda')
    lead = shape[:-2]
    h = torch.randn(*shape, generator=gen).to(dev)
    b = (torch.rand(*lead, shape[-1], generator=gen) - 0.5).to(dev)
    g = torch.randn(*shape, generator=gen).to(dev)
    hk, bk = h.clone().requires_grad_(), b.clone().requires_grad_()
    snake.bias_snake(hk, bk).backward(g)
    hp, bp = h.clone().requires_grad_(), b.clone().requires_grad_()
    yp = snake.bias_snake_plain(hp, bp)
    yp.backward(g)
    hd, bd = h.double().requires_grad_(), b.double().requires_grad_()
    yd = snake.bias_snake_plain(hd, bd)
    yd.backward(g.double())
    y = snake.bias_snake(h, b)
    torch.cuda.synchronize()
    return (h, b, g), {'fwd': judge([(y, yp, yd)]),
                       'bwd': judge([(hk.grad, hp.grad, hd.grad),
                                     (bk.grad, bp.grad, bd.grad)])}


def k2_entries(gen, shape, names, also_judge=()):
    """K2's forward and backward entries at `shape`, named `names`, judged
    there and at the shapes of `also_judge`."""
    import torch
    from npp_tpu_torch.kernels import snake
    (h, b, g), errs = _k2_check(gen, shape)
    for other in also_judge:
        more = _k2_check(gen, other)[1]
        errs = {k: merge(errs[k], more[k]) for k in errs}
    bb = b[:, None, :] if h.dim() == 3 else b

    def plain_bwd():
        return g * (1.0 + torch.sin(2.0 * (h + bb)))
    numel = h.numel()
    out = []
    # forward: h read, y written; backward: g and h read, dh written
    for key, name, kernel, plain, n_bytes, ops in (
            ('fwd', names[0], lambda: snake.snake_fwd_launch(h, b),
             lambda: snake.bias_snake_plain(h, b), 2 * numel * 4, 4 * numel),
            ('bwd', names[1], lambda: snake.snake_bwd_launch(g, h, b),
             plain_bwd, 3 * numel * 4, 5 * numel)):
        b_ms, b_by = bound_ms(n_bytes, ops)
        out.append(dict(
            name=name, route='triton',
            source='npp_tpu_torch/kernels/snake.py',
            replaces='npp_tpu/nn/mlp.py:69 (act(TorchLinear), XLA-fused '
                     'epilogue; no pl.pallas_call in the repo)',
            shape=list(shape), **errs[key], **device_times(kernel),
            eager_ms=eager_ms(kernel), plain_ms=time_ms(plain),
            bound_ms=b_ms, bound_us=1e3 * b_ms, bound_by=b_by,
            library_ms=None))
    return out


# the search's lockstep fit: 9 candidates x N_rand 2048 rows, its four
# periodic layers at width 256 and pos_0 at 128; its pixel loss as one
# (2048, 9 x 3) K4 launch each way
SEARCH_K2 = [(9, 2048, 256), (9, 2048, 128)]
SEARCH_K4 = (2048, 27)


def check_k2(gen):
    """K2 forward and backward at the main path's (59392, 512) (also
    judged at (59392, 256)), and batched at the search's shapes."""
    m = 8192 + 2 * 160 * 160
    out = k2_entries(gen, (m, 512), ('bias_snake_fwd', 'bias_snake_bwd'),
                     also_judge=[(m, 256)])
    for shape in SEARCH_K2:
        key = 'x'.join(map(str, shape))
        out += k2_entries(gen, shape, (f'bias_snake_fwd[{key}]',
                                       f'bias_snake_bwd[{key}]'))
    return out


# the main path's K4 shapes: the pixel loss, then each LPIPS layer at six
# 160x160 patches (forward: one grouped launch for the five layers)
K4_PIXEL = (8192, 3)
K4_LPIPS = [(6 * s * s, c) for s, c in
            ((160, 64), (80, 128), (40, 256), (20, 512), (10, 512))]
K4_ALPHAS = ('spread', 0.001, 1.0, 1.999)
K4_REPLACES = ('npp_tpu/losses/robust.py:134 (nllfun per-element rho{}, '
               'XLA-fused; no pl.pallas_call in the repo)')
FWD_F64_BAR = 1e-6   # K4 forward against float64, relative to its largest


def k4_inputs(gen, m, c, alpha):
    """x ~ N(0, 0.2^2) (m, c) and alpha, scale, w (c,) on the card: alpha
    spread over the adaptive range (0.001, 1.999) or every channel at
    `alpha`; w = 1 for the pixel loss's three channels."""
    import torch
    dev = torch.device('cuda')
    x = (torch.randn(m, c, generator=gen) * 0.2).to(dev)
    a = (0.001 + 1.998 * torch.rand(c, generator=gen)) if alpha == 'spread' \
        else torch.full((c,), alpha)
    scale = 0.01 + torch.rand(c, generator=gen)
    w = torch.ones(c) if c == 3 else torch.rand(c, generator=gen)
    return x, a.to(dev), scale.to(dev), w.to(dev)


def judge_k4_fwd(gen, shapes):
    """K4's forward at `shapes`, one launch for all of them (one shape:
    the single launch), at every alpha of K4_ALPHAS: judge() against the
    plain version per shape, and FWD_F64_BAR against float64. Returns the
    worst judge() result with 'passed' covering both."""
    import torch
    from npp_tpu_torch.kernels import robust_rho as rr
    worst = None
    for alpha in K4_ALPHAS:
        segs = [k4_inputs(gen, m, c, alpha) for m, c in shapes]
        got = rr.rho_fwd_group_launch(segs)
        torch.cuda.synchronize()
        for r, seg in zip(got, segs):
            e = judge([(r, rr.rho_rows_plain(*seg),
                        rr.rho_rows_plain(*[t.double() for t in seg]))])
            e['passed'] = e['passed'] and e['rel_err_vs_f64'] <= FWD_F64_BAR
            worst = e if worst is None else merge(worst, e)
    return worst


def k4_entry(name, source, shape, err, kernel, plain, n_bytes, ops, **extra):
    b_ms, b_by = bound_ms(n_bytes, ops)
    return dict(name=name, route='cuda', source=source,
                replaces=K4_REPLACES.format(', its gradient' if 'bwd' in name
                                            else ''),
                shape=shape, **err, **device_times(kernel),
                eager_ms=eager_ms(kernel), plain_ms=time_ms(plain),
                bound_ms=b_ms, bound_us=1e3 * b_ms, bound_by=b_by,
                library_ms=None, **extra)


FWD_SRC = 'npp_tpu_torch/csrc/robust_rho_fwd.cu'
BWD_SRC = 'npp_tpu_torch/csrc/robust_rho_bwd.cu'


def fwd_bytes_ops(m, c):
    """K4 forward: x read, r written, alpha, scale and w read (C each)."""
    return (m * c + m + 3 * c) * 4, 30 * m * c


def check_k4(gen):
    """K4's forward at the pixel loss's shape, the five LPIPS layers in one
    grouped launch (judged per segment; each layer also timed alone, under
    'segments'), and the evaluation's train- and hole-pixel shapes; its
    backward (dx, dalpha, dscale) at the pixel loss's and each LPIPS
    layer's shape. One entry per direction and shape (the group: one
    entry), named like the launch counts."""
    import torch
    from npp_tpu_torch.kernels import robust_rho as rr
    from npp_tpu_torch.utils.synthetic import synthetic_data
    data = synthetic_data(0)
    out = []
    for m, c in [K4_PIXEL] + [(len(ix), 3) for ix in (data.i_train,
                                                       data.i_val)]:
        err = judge_k4_fwd(gen, [(m, c)])
        x, alpha, scale, w = k4_inputs(gen, m, c, 'spread')
        out.append(k4_entry(
            f'robust_rho_fwd[{m}x{c}]', FWD_SRC, [m, c], err,
            lambda: rr.rho_fwd_launch(x, alpha, scale, w),
            lambda: rr.rho_rows_plain(x, alpha, scale, w),
            *fwd_bytes_ops(m, c)))

    err = judge_k4_fwd(gen, K4_LPIPS)
    segs = [k4_inputs(gen, m, c, 'spread') for m, c in K4_LPIPS]
    singles = []
    for (m, c), seg in zip(K4_LPIPS, segs):
        b_ms, _ = bound_ms(*fwd_bytes_ops(m, c))
        singles.append(dict(
            shape=[m, c], **device_times(lambda: rr.rho_fwd_launch(*seg)),
            eager_ms=eager_ms(lambda: rr.rho_fwd_launch(*seg)),
            bound_ms=b_ms))
    n_bytes, ops = (sum(v) for v in zip(*[fwd_bytes_ops(m, c)
                                          for m, c in K4_LPIPS]))
    shapes = ','.join(f'{m}x{c}' for m, c in K4_LPIPS)
    out.append(k4_entry(
        f'robust_rho_fwd_group[{shapes}]', FWD_SRC,
        [list(sh) for sh in K4_LPIPS], err,
        lambda: rr.rho_fwd_group_launch(segs),
        lambda: rr.rho_rows_group_plain(*zip(*segs)), n_bytes, ops,
        segments=singles))

    for m, c in [K4_PIXEL] + K4_LPIPS:
        out.append(k4_bwd_entry(gen, m, c, ('spread',)))

    # the search's lockstep fit, every alpha both ways
    m, c = SEARCH_K4
    err = judge_k4_fwd(gen, [(m, c)])
    x, alpha, scale, w = k4_inputs(gen, m, c, 'spread')
    out.append(k4_entry(
        f'robust_rho_fwd[{m}x{c}]', FWD_SRC, [m, c], err,
        lambda: rr.rho_fwd_launch(x, alpha, scale, w),
        lambda: rr.rho_rows_plain(x, alpha, scale, w),
        *fwd_bytes_ops(m, c)))
    out.append(k4_bwd_entry(gen, m, c, K4_ALPHAS))
    return out


def k4_bwd_entry(gen, m, c, alphas):
    """K4's backward (dx, dalpha, dscale) at (m, c), judged at each alpha
    of `alphas`, timed at the last."""
    import torch
    from npp_tpu_torch.kernels import robust_rho as rr
    err = None
    for a in alphas:
        x, alpha, scale, w = k4_inputs(gen, m, c, a)
        g = torch.randn(m, generator=gen).to(x.device)
        ins_k = [t.clone().requires_grad_() for t in (x, alpha, scale)]
        ins_p = [t.clone().requires_grad_() for t in (x, alpha, scale)]
        rr.rho_rows(*ins_k, w).backward(g)
        rr.rho_rows_plain(*ins_p, w).backward(g)
        ins_d = [t.double().requires_grad_() for t in (x, alpha, scale)]
        rr.rho_rows_plain(*ins_d, w.double()).backward(g.double())
        torch.cuda.synchronize()
        e = judge([(p.grad, q.grad, d.grad) for p, q, d in
                   zip(ins_k, ins_p, ins_d)])
        err = e if err is None else merge(err, e)

    def plain_bwd():
        xs, a_, s_ = (t.detach().requires_grad_() for t in (x, alpha, scale))
        return torch.autograd.grad(rr.rho_rows_plain(xs, a_, s_, w),
                                   (xs, a_, s_), g)
    # x and g read, dx, dalpha and dscale written (alpha, scale and w are
    # C values each)
    return k4_entry(f'robust_rho_bwd[{m}x{c}]', BWD_SRC, [m, c], err,
                    lambda: rr.rho_bwd_launch(g, x, alpha, scale, w),
                    plain_bwd, (2 * m * c + m + 5 * c) * 4, 60 * m * c)


# the main path's step rows (N_rand + 2 fake 160^2 patches): K1's backward
# runs at this shape on every step of the warp path
K1_BWD_ROWS = 8192 + 2 * 160 * 160


def check_k1_bwd(gen):
    """K1's backward at (59,392, 1,386): the coordinate gradient at
    non-integer coordinates of the canvas, against autograd through the
    plain version in f32 and float64 (judge())."""
    import torch
    from npp_tpu_torch.kernels import periodic_embed as pe
    from npp_tpu_torch.utils.synthetic import H, W, synthetic_data
    data = synthetic_data(0)
    dev = torch.device('cuda')
    n = K1_BWD_ROWS
    coords = (torch.rand(n, 2, generator=gen) *
              torch.tensor([H - 1.0, W - 1.0])).to(dev)
    consts = (torch.tensor(data.selected_angles, device=dev).float(),
              torch.tensor(data.selected_periods, device=dev).float(),
              (torch.randn(10, generator=gen) * 10).to(dev))
    cfg = ((1.0,), (0.0, -1.0, 1.0, 0.5, -0.5), (0.0,), (H, W))
    g = torch.randn(n, 1386, generator=gen).to(dev)
    grads = []
    for fn, dt in ((pe.periodic_embed, torch.float32),
                   (pe.periodic_embed_plain, torch.float32),
                   (pe.periodic_embed_plain, torch.float64)):
        c = coords.to(dt, copy=True).requires_grad_()
        fn(c, *[t.to(dt) for t in consts], *cfg).backward(g.to(dt))
        grads.append(c.grad)
    torch.cuda.synchronize()
    err = judge([grads])
    del grads
    args = pe._Args(coords, *consts, *cfg)

    def plain():
        c = coords.detach().requires_grad_()
        return torch.autograd.grad(pe.periodic_embed_plain(c, *consts, *cfg),
                                   c, g)
    # the gradient read once, the coordinates read and their gradient
    # written; a sincos and a few multiply-adds per gradient value
    b_ms, b_by = bound_ms((n * 1386 + 4 * n) * 4, n * 1386 * 24)
    return [dict(
        name='periodic_embed_bwd', route='cuda',
        source='npp_tpu_torch/csrc/periodic_embed.cu',
        replaces='npp_tpu/nn/embedder.py:149 (TaskEmbedder.embed) '
                 'differentiated in the coordinates by JAX (XLA-fused; the '
                 'warp field, nn/warp.py; no pl.pallas_call in the repo)',
        shape=[n, 1386], **err,
        **device_times(lambda: pe.periodic_embed_bwd_launch(g, coords, args)),
        eager_ms=eager_ms(lambda: pe.periodic_embed_bwd_launch(g, coords,
                                                               args)),
        plain_ms=time_ms(plain, iters=5), bound_ms=b_ms, bound_us=1e3 * b_ms,
        bound_by=b_by, library_ms=None)]


# the remapping's adaptive style loss: the flattened Gram residuals of
# pool1..pool3 over P*K = 6 patches, K4's wide rows; the forward is one
# grouped launch for the three layers
K4_STYLE = [(6, 64 * 64), (6, 128 * 128), (6, 256 * 256)]
K4_WIDE_ALPHAS = (0.001, 1.0, 1.999)


def check_k4_wide(gen):
    """K4's wide rows at the style shapes: the grouped forward (judged per
    segment, each also timed alone) and the backward per shape, at every
    alpha of K4_WIDE_ALPHAS and spread, against the plain version in f32
    and float64."""
    from npp_tpu_torch.kernels import robust_rho as rr
    err = None
    for alpha in ('spread',) + K4_WIDE_ALPHAS:
        segs = [k4_inputs(gen, m, c, alpha) for m, c in K4_STYLE]
        got = rr.rho_fwd_group_launch(segs)
        for r, seg in zip(got, segs):
            e = judge([(r, rr.rho_rows_plain(*seg),
                        rr.rho_rows_plain(*[t.double() for t in seg]))])
            e['passed'] = e['passed'] and e['rel_err_vs_f64'] <= FWD_F64_BAR
            err = e if err is None else merge(err, e)
    segs = [k4_inputs(gen, m, c, 'spread') for m, c in K4_STYLE]
    singles = []
    for (m, c), seg in zip(K4_STYLE, segs):
        b_ms, _ = bound_ms(*fwd_bytes_ops(m, c))
        singles.append(dict(
            shape=[m, c], **device_times(lambda: rr.rho_fwd_launch(*seg)),
            eager_ms=eager_ms(lambda: rr.rho_fwd_launch(*seg)),
            bound_ms=b_ms))
    n_bytes, ops = (sum(v) for v in zip(*[fwd_bytes_ops(m, c)
                                          for m, c in K4_STYLE]))
    shapes = ','.join(f'{m}x{c}' for m, c in K4_STYLE)
    out = [k4_entry(f'robust_rho_fwd_group[{shapes}]', FWD_SRC,
                    [list(sh) for sh in K4_STYLE], err,
                    lambda: rr.rho_fwd_group_launch(segs),
                    lambda: rr.rho_rows_group_plain(*zip(*segs)), n_bytes,
                    ops, segments=singles)]
    for m, c in K4_STYLE:
        out.append(k4_bwd_entry(gen, m, c, ('spread',) + K4_WIDE_ALPHAS))
    return out


def draw_batch(gen, sampler, p, s, k, ratio, want, tries=500):
    """The first of `tries` sampled batches that `want` accepts."""
    from npp_tpu_torch.models.sampler import sample_patches
    for _ in range(tries):
        batch = sample_patches(gen, sampler, p, s, k, ratio)
        if want(batch):
            return batch
    fail(f'no batch of {tries} draws has the wanted patches')


def check_step(label, cfg, data, task=None, want=lambda batch: True):
    """One fit step of `task` (completion by default) with the same
    parameters and injected batch on the card (kernels) and on the CPU
    (plain versions): loss and every gradient agree. `want(batch)` picks
    the batch (drawn on the CPU, seed 3). Small widths;
    matmul_precision='float32', so full f32 on both sides (TF32 would
    break the tolerances below)."""
    import torch
    from npp_tpu_torch.device import matmul_precision
    from npp_tpu_torch.models.pipeline import build_components, make_fit_consts
    from npp_tpu_torch.models.trainer import (COMPLETION_TASK, build_loss_fn,
                                              init_fit_state)
    task = task or COMPLETION_TASK
    p, s, k = cfg.patch_num, data.patch_size, cfg.num_real_patch_per_sample
    cpu = torch.device('cpu')
    gen = torch.Generator().manual_seed(3)
    consts = make_fit_consts(cfg, data, s, cpu, task)
    batch = draw_batch(gen, consts.sampler, p, s, k, 0.3, want)
    pix = torch.randint(0, consts.pool_train_n, (cfg.N_rand,), generator=gen)
    res = {}
    for name in ('cpu', 'cuda'):
        dev = torch.device(name)
        # the same init on both devices (drawn on the CPU from cfg.seed)
        comps = build_components(cfg, data, dev, task)
        st = init_fit_state(cfg, comps.model, comps.percep, dev, comps.style)
        off = torch.Generator().manual_seed(4)
        with torch.no_grad():   # the latents and the warp's output layer
            for k_, v in st.params.named_parameters():   # off their init
                if 'latent' in k_ or k_.startswith('warp.out'):
                    v.copy_(0.3 * torch.randn(v.shape, generator=off))
        inj = (pix, type(batch)(*[t.to(dev) if torch.is_tensor(t) else t
                                  for t in vars(batch).values()]))
        loss_fn = build_loss_fn(cfg, comps.percep, comps.contextual, p, s,
                                inject=inj, style=comps.style, task=task)
        with matmul_precision(cfg.matmul_precision):
            loss, _ = loss_fn(st.params, comps.embedder,
                              make_fit_consts(cfg, data, s, dev, task), None)
            loss.backward()
        res[name] = (loss.detach().cpu(),
                     {k_: q.grad.cpu() for k_, q in
                      st.params.named_parameters() if q.grad is not None})

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    l_err = rel(res['cuda'][0], res['cpu'][0])
    g_err = {k_: rel(res['cuda'][1][k_], v) for k_, v in res['cpu'][1].items()}
    worst = max(g_err, key=g_err.get)
    log(f'{label} card vs CPU: loss {float(res["cuda"][0]):.6f} vs '
        f'{float(res["cpu"][0]):.6f} (rel {l_err:.2e}), worst gradient rel '
        f'err {g_err[worst]:.2e} ({worst}) over {len(g_err)} tensors')
    # f32 on both sides; convolutions and reductions reassociate
    if not (l_err < 1e-4 and g_err[worst] < 1e-2 and
            set(res['cuda'][1]) == set(res['cpu'][1])):
        fail(f'{label} on the card disagrees with the CPU')
    return dict(loss_rel_err=l_err, worst_grad_rel_err=g_err[worst],
                worst_grad=worst, tensors=len(g_err))


def check_fit_step():
    """One completion step with every loss on (a 'same' batch, so the
    LPIPS-robust term is on), and one with the warp field (K1's backward),
    card against CPU."""
    from npp_tpu_torch.config import CompletionConfig, replace
    from npp_tpu_torch.models.sampler import SOURCE_SAME
    from npp_tpu_torch.utils.synthetic import synthetic_data
    cfg = replace(CompletionConfig(), netwidth=64, netdepth=6, N_rand=512,
                  patch_num=1, num_real_patch_per_sample=2,
                  matmul_precision='float32')
    data = synthetic_data(0, 96, 128)
    data.patch_size = 32
    return {'completion': check_step(
                'fit step', cfg, data,
                want=lambda b: b.source == SOURCE_SAME),
            'warp': check_step('warp fit step', replace(cfg, warp_field=True),
                               data)}


def check_remap_step():
    """One remapping step (pixel loss weighted by the clear mask, CX, the
    adaptive style loss through K4's wide rows) on a batch with both real
    patches valid, card against CPU, the style latents' gradients
    included."""
    import torch
    from npp_tpu_torch.config import RemappingConfig, replace
    from npp_tpu_torch.models.loaders import remapping_data
    from npp_tpu_torch.models.remapping import REMAPPING_TASK
    from npp_tpu_torch.utils.synthetic import synthetic_remap_data
    cfg = replace(RemappingConfig(), netwidth=64, netdepth=6, N_rand=512,
                  patch_num=1, num_real_patch_per_sample=2,
                  matmul_precision='float32')
    # 96x128, its clear mask from the blur map on the CPU, patch size 32
    data = remapping_data(synthetic_remap_data(0, 96, 128), cfg,
                          torch.device('cpu'))
    data.patch_size = 32
    return check_step('remapping step', cfg, data, REMAPPING_TASK,
                      want=lambda b: float(b.valid.sum()) == 2)


TF32_COSINE_BAR = 0.99


def cosine(a, b):
    import torch
    a, b = a.double().flatten(), b.double().flatten()
    return float(torch.dot(a, b) / (a.norm() * b.norm()).clamp(min=1e-300))


def bf16_tower(loss):
    """The loss, after checking that its tower carries bf16 activations
    (feature_dtype='bfloat16' is not ignored)."""
    import torch
    if loss.tower.dtype != torch.bfloat16:
        fail(f'feature_dtype=\'bfloat16\' built a {loss.tower.dtype} '
             f'tower for {type(loss).__name__}')
    return loss


def check_tf32_gradients():
    """The fit's default matmul_precision ('bfloat16': TF32 on the card)
    against 'float32' (TF32 off), on one card and the same inputs, at the
    flagship patch scale (default CompletionConfig widths, 2 fake 160^2
    patches with K=3 real ones each, a 'same' batch of the 384x512
    example): the cosine between the two gradients of the CX term and of
    the LPIPS-robust term with respect to the predicted patches, and of one
    whole default step's loss with respect to the MLP's parameters. The
    predicted patches for the two terms are the fake patches' known pixels,
    gray in the hole, plus N(0, 0.05^2) noise: a fit part of the way. Fails
    below TF32_COSINE_BAR."""
    import torch
    from npp_tpu_torch.config import CompletionConfig, replace
    from npp_tpu_torch.device import matmul_precision
    from npp_tpu_torch.kernels import launch_counts
    from npp_tpu_torch.models.pipeline import build_components, make_fit_consts
    from npp_tpu_torch.models.sampler import SOURCE_SAME, sample_patches
    from npp_tpu_torch.models.trainer import build_loss_fn, init_fit_state
    from npp_tpu_torch.utils.synthetic import synthetic_data
    cfg = CompletionConfig()
    data = synthetic_data(0)
    dev = torch.device('cuda')
    comps = build_components(cfg, data, dev)
    state = init_fit_state(cfg, comps.model, comps.percep, dev)
    p, s, k = cfg.patch_num, data.patch_size, cfg.num_real_patch_per_sample
    consts = make_fit_consts(cfg, data, s, dev)
    gen = torch.Generator().manual_seed(5)
    while True:
        batch = sample_patches(gen, consts.sampler, p, s, k,
                               cfg.invalid_ratio)
        if batch.source == SOURCE_SAME:
            break
    pk = p * k
    real_rgb = batch.real_rgb.reshape(pk, s, s, 3)
    real_mask = batch.real_mask.reshape(pk, s, s, 1)
    fake_mask = batch.fake_mask.reshape(p, s, s, 1)
    fake_rgb = batch.fake_rgb.reshape(p, s, s, 3)
    valid = batch.valid.reshape(pk)
    noise = (0.05 * torch.randn(p, s, s, 3, generator=gen)).to(dev)
    pred0 = torch.clamp(fake_rgb * fake_mask + 0.5 * (1.0 - fake_mask) +
                        noise, 0.0, 1.0)

    def per_slot(t):
        return t[:, None].expand((p, k) + t.shape[1:]).reshape(
            (pk,) + t.shape[1:])

    terms = {
        'contextual': lambda pred: comps.contextual(
            per_slot(pred) * real_mask, real_rgb * real_mask, valid=valid),
        'lpips_robust': lambda pred: torch.sum(comps.percep(
            per_slot(pred) * real_mask, per_slot(fake_rgb) * real_mask,
            use_robust=True, adaptive=state.params.adaptive_percep,
            normalize=True)),
    }
    pix = torch.randint(0, consts.pool_train_n, (cfg.N_rand,), generator=gen)
    loss_fn = build_loss_fn(cfg, comps.percep, comps.contextual, p, s,
                            inject=(pix, batch))
    grads = {}
    k3_before = launch_counts().get(k3_name('bwd', *K3_FIT), 0)
    for prec in (cfg.matmul_precision, 'float32'):
        with matmul_precision(prec):
            for name, term in terms.items():
                pred = pred0.clone().requires_grad_()
                grads.setdefault(name, []).append(
                    torch.autograd.grad(term(pred), pred)[0])
            state.params.zero_grad(set_to_none=True)
            loss, _ = loss_fn(state.params, comps.embedder, consts, None)
            loss.backward()
        grads.setdefault('mlp_step', []).append(torch.cat(
            [q.grad.flatten() for q in state.params.mlp.parameters()]))
    # feature_dtype='bfloat16': the LPIPS tower that build_components makes
    # for it, bf16 activations under the default precision, against the
    # f32 tower in full f32
    percep_bf16 = bf16_tower(build_components(
        replace(cfg, feature_dtype='bfloat16'), data, dev).percep)
    for prec, lp in ((cfg.matmul_precision, percep_bf16),
                     ('float32', comps.percep)):
        with matmul_precision(prec):
            pred = pred0.clone().requires_grad_()
            term = torch.sum(lp(
                per_slot(pred) * real_mask, per_slot(fake_rgb) * real_mask,
                use_robust=True, adaptive=state.params.adaptive_percep,
                normalize=True))
            grads.setdefault('lpips_robust_bf16_towers', []).append(
                torch.autograd.grad(term, pred)[0])
    if launch_counts().get(k3_name('bwd', *K3_FIT), 0) < k3_before + 2:
        fail('TF32 gradients: the CX term did not go through K3 both ways')
    res = {name: cosine(*g) for name, g in grads.items()}
    res.update(tf32_style_cosines())
    log(f'TF32 on ({cfg.matmul_precision!r}) against off (\'float32\'), '
        f'flagship patch scale: gradient cosines {res}')
    low = [n for n, v in res.items() if not v >= TF32_COSINE_BAR]
    if low:
        fail(f'TF32 turns these gradients by more than a cosine of '
             f'{TF32_COSINE_BAR}: {low}')
    same = [n for n, v in res.items() if n.endswith('_bf16_towers')
            and not v < 1.0]
    if same:
        fail(f'bf16 towers give the f32 towers\' gradient exactly: {same}')
    return res


def remap_data_full():
    """The flagship remapping example (utils/synthetic.py::
    synthetic_remap_data, 384x512) as the loader makes it, its blur map on
    the card."""
    import torch
    from npp_tpu_torch.config import RemappingConfig
    from npp_tpu_torch.models.loaders import remapping_data
    from npp_tpu_torch.utils.synthetic import synthetic_remap_data
    return remapping_data(synthetic_remap_data(0), RemappingConfig(),
                          torch.device('cuda'))


def tf32_style_cosines():
    """The remapping's TF32 gradients against full f32 on the flagship
    remapping example at the default RemappingConfig (patch 64, 2 fake
    patches with K=3 real ones each, a batch with every real patch valid):
    the adaptive style term's gradient in the predicted patches (the
    known-pixel paste plus N(0, 0.05^2) noise, as for CX), and one whole
    remapping step's gradient in the MLP's parameters."""
    import torch
    from npp_tpu_torch.config import RemappingConfig, replace
    from npp_tpu_torch.device import matmul_precision
    from npp_tpu_torch.models.pipeline import build_components, make_fit_consts
    from npp_tpu_torch.models.remapping import REMAPPING_TASK
    from npp_tpu_torch.models.trainer import build_loss_fn, init_fit_state
    cfg = RemappingConfig()
    task = REMAPPING_TASK
    data = remap_data_full()
    dev = torch.device('cuda')
    comps = build_components(cfg, data, dev, task)
    state = init_fit_state(cfg, comps.model, comps.percep, dev, comps.style)
    p, s, k = cfg.patch_num, data.patch_size, cfg.num_real_patch_per_sample
    consts = make_fit_consts(cfg, data, s, dev, task)
    gen = torch.Generator().manual_seed(6)
    batch = draw_batch(gen, consts.sampler, p, s, k, cfg.invalid_ratio,
                       lambda b: float(b.valid.sum()) == p * k)
    pk = p * k
    real_rgb = batch.real_rgb.reshape(pk, s, s, 3)
    real_mask = batch.real_mask.reshape(pk, s, s, 1)
    fake_mask = batch.fake_mask.reshape(p, s, s, 1)
    fake_rgb = batch.fake_rgb.reshape(p, s, s, 3)
    noise = (0.05 * torch.randn(p, s, s, 3, generator=gen)).to(dev)
    pred0 = torch.clamp(fake_rgb * fake_mask + 0.5 * (1.0 - fake_mask) +
                        noise, 0.0, 1.0)
    pix = torch.randint(0, consts.pool_train_n, (cfg.N_rand,), generator=gen)
    loss_fn = build_loss_fn(cfg, comps.percep, comps.contextual, p, s,
                            inject=(pix, batch), style=comps.style, task=task)
    grads = {}
    for prec in (cfg.matmul_precision, 'float32'):
        with matmul_precision(prec):
            pred = pred0.clone().requires_grad_()
            term = comps.style(
                pred[:, None].expand(p, k, s, s, 3).reshape(pk, s, s, 3) *
                real_mask, real_rgb * real_mask,
                adaptive=state.params.adaptive_style,
                valid=batch.valid.reshape(pk))
            grads.setdefault('style', []).append(
                torch.autograd.grad(term, pred)[0])
            state.params.zero_grad(set_to_none=True)
            loss, _ = loss_fn(state.params, comps.embedder, consts, None)
            loss.backward()
        grads.setdefault('remap_mlp_step', []).append(torch.cat(
            [q.grad.flatten() for q in state.params.mlp.parameters()]))
    # feature_dtype='bfloat16': the style tower that build_components makes
    # for it (tower, Grams and residual in bf16) under the default
    # precision, against the f32 tower in full f32
    style_bf16 = bf16_tower(build_components(
        replace(cfg, feature_dtype='bfloat16'), data, dev, task).style)
    for prec, st in ((cfg.matmul_precision, style_bf16),
                     ('float32', comps.style)):
        with matmul_precision(prec):
            pred = pred0.clone().requires_grad_()
            term = st(pred[:, None].expand(p, k, s, s, 3).reshape(
                pk, s, s, 3) * real_mask, real_rgb * real_mask,
                adaptive=state.params.adaptive_style,
                valid=batch.valid.reshape(pk))
            grads.setdefault('style_bf16_towers', []).append(
                torch.autograd.grad(term, pred)[0])
    return {name: cosine(*g) for name, g in grads.items()}


def check_blur_map():
    """The blur map of the flagship remapping example with its windows'
    eigenvalues on the card and on the CPU: the normalised degree maps'
    largest difference and the clear masks' agreement (the f32 eigenvalues
    of the near-singular Grams differ between solvers by about 5e-3 of the
    degree range; tests/test_torch_remap.py), and the card's time."""
    import numpy as np
    import torch
    from npp_tpu_torch.ops import blur
    from npp_tpu_torch.utils.synthetic import synthetic_remap_data
    img = np.uint8(synthetic_remap_data(0)['gt_img'] * 255)
    maps = {}
    for name in ('cuda', 'cpu'):
        blur.degree_map(img, device=torch.device(name))   # warm
        t0 = time.time()
        maps[name] = blur.blur_map(img, device=torch.device(name))
        maps[name + '_s'] = time.time() - t0
    diff = float(np.abs(maps['cuda'][0] - maps['cpu'][0]).max())
    agree = float((maps['cuda'][1] == maps['cpu'][1]).mean())
    clear = float((maps['cuda'][1] > 0).mean())
    log(f"blur map 384x512, card vs CPU: degree max diff {diff:.2e}, clear "
        f"masks agree on {agree:.6f} of pixels, clear share {clear:.4f}; "
        f"{maps['cuda_s']:.3f} s on the card ({maps['cpu_s']:.3f} s CPU)")
    if not (diff < 2e-2 and agree >= 0.999 and 0.0 < clear < 1.0):
        fail('blur map on the card disagrees with the CPU')
    return dict(degree_max_diff=diff, mask_agreement=agree,
                clear_share=clear, card_s=maps['cuda_s'],
                cpu_s=maps['cpu_s'])


def drive_remap():
    """run_remapping on the flagship remapping example at the default
    RemappingConfig widths, 21 iterations (evals at 10 and 20, the final
    render, LPIPS and guard), every launch count set to 0 just before and
    read just after. Fails on non-finite losses or metrics, a style term
    that stays 0, or a kernel of the path that never launched: K1, K2, and
    K4 forward (the grouped style launch) and backward at every style
    shape, once per step."""
    import numpy as np
    import torch
    from npp_tpu_torch.config import RemappingConfig, replace
    from npp_tpu_torch.kernels import launch_counts, reset_launches
    from npp_tpu_torch.models.remapping import run_remapping
    from npp_tpu_torch.utils.synthetic import synthetic_remap_data
    cfg = replace(RemappingConfig(), N_iters=21, i_testset=10, i_print=10)
    arrays = synthetic_remap_data(0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    result, final, evals = run_remapping(cfg, save=False, device='cuda',
                                         data=arrays)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for h in result.history:
        log(f"remapping path: block ending at iter {h['iter']}: loss "
            f"{h['loss']:.6g} (style {h['style']:.6g}), "
            f"{h['ms_per_step']:.2f} ms/step")
    for i, e in sorted(evals.items()):
        log(f"remapping path: eval@{i}: train_psnr {e['train_psnr']:.3f} "
            f"val_psnr {e['val_psnr']:.3f}")
    log(f"remapping path: final: train_psnr {final['train_psnr']:.3f} "
        f"val_psnr {final['val_psnr']:.3f} full_lpips "
        f"{final['full_lpips']:.5f} clear_lpips {final['clear_lpips']:.5f}")
    log(f'remapping path: {wall:.1f} s wall; peak memory allocated '
        f'{peak / 2**30:.2f} GiB; launches {launches}')
    numbers = [h[k] for h in result.history for k in ('loss', 'style')] + \
        [final[k] for k in ('train_psnr', 'val_psnr', 'full_lpips',
                            'clear_lpips')]
    if not np.all(np.isfinite(numbers)) or \
            not any(h['style'] > 0 for h in result.history):
        fail(f'remapping path: non-finite or missing style/metrics: {numbers}')
    if sorted(evals) != [10, 20]:
        fail(f'remapping path: evals at {sorted(evals)}')
    steps = cfg.N_iters - 1
    shapes = ','.join(f'{m}x{c}' for m, c in K4_STYLE)
    want = {f'robust_rho_fwd_group[{shapes}]': steps,
            **{f'robust_rho_bwd[{m}x{c}]': steps for m, c in K4_STYLE}}
    wrong = {k: launches.get(k, 0) for k, v in want.items()
             if launches.get(k, 0) != v}
    missing = [k for k in ('periodic_embed', 'bias_snake_fwd',
                           'bias_snake_bwd', *k3_names(K3_PATCH64))
               if launches.get(k, 0) <= 0]
    if wrong or missing:
        fail(f'remapping path: launch counts {wrong}, expected {want}; '
             f'never launched: {missing}')
    return launches, dict(
        ms_per_step=[h['ms_per_step'] for h in result.history],
        train_psnr=final['train_psnr'], val_psnr=final['val_psnr'],
        full_lpips=final['full_lpips'], clear_lpips=final['clear_lpips'],
        evals=evals, wall_s=wall, peak_bytes=peak)


def drive(label, must_launch, data=None, every=10, **overrides):
    """run_completion on the 384x512 synthetic example (or `data`, the same
    image with other lattices) at the default CompletionConfig widths with
    `overrides` and evals and logs every `every` steps, every launch count
    set to 0 just before and read just after. Fails on non-finite losses or
    metrics, a wrong composite, missing evals, or a kernel of `must_launch`
    (a name of launch_counts(), with or without its shape) that never
    launched."""
    import numpy as np
    import torch
    from npp_tpu_torch.config import CompletionConfig, replace
    from npp_tpu_torch.kernels import launch_counts, reset_launches
    from npp_tpu_torch.models.completion import run_completion
    from npp_tpu_torch.utils.synthetic import H, W, synthetic_data
    cfg = replace(CompletionConfig(), i_testset=every, i_print=every,
                  **overrides)
    data = synthetic_data(0) if data is None else data
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    result, final, evals = run_completion(cfg, save=False, device='cuda',
                                          data=data)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for h in result.history:
        log(f"{label}: block ending at iter {h['iter']}: loss "
            f"{h['loss']:.6g}, {h['ms_per_step']:.2f} ms/step")
    for i, e in sorted(evals.items()):
        log(f"{label}: eval@{i}: train_psnr {e['train_psnr']:.3f} val_psnr "
            f"{e['val_psnr']:.3f}")
    log(f"{label}: final: train_psnr {final['train_psnr']:.3f} val_psnr "
        f"{final['val_psnr']:.3f} val_lpips {final['val_lpips']:.5f}")
    log(f'{label}: {wall:.1f} s wall; peak memory allocated '
        f'{peak / 2**30:.2f} GiB; launches {launches}')
    log(f"{label}: seam composite: val_psnr_seam "
        f"{final.get('val_psnr_seam', float('nan')):.3f} val_lpips_seam "
        f"{final.get('val_lpips_seam', float('nan')):.5f}")
    if 'pred_rgb_img_comp_seam' not in final or \
            final['pred_rgb_img_comp_seam'].shape != (H, W, 3):
        fail(f'{label}: the final outputs lack the seam composite')
    numbers = [h['loss'] for h in result.history] + \
        [final[k] for k in ('train_psnr', 'val_psnr', 'val_lpips',
                            'val_psnr_seam', 'val_lpips_seam')] + \
        [e[k] for e in evals.values() for k in ('train_psnr', 'val_psnr')]
    if not np.all(np.isfinite(numbers)):
        fail(f'{label}: non-finite losses or metrics: {numbers}')
    comp = final['pred_rgb_img_comp']
    if comp.shape != (H, W, 3) or not np.all(np.isfinite(comp)) or \
            not np.all(np.isfinite(final['pred_rgb_img_comp_seam'])):
        fail(f'{label}: composite of shape {comp.shape} or not finite')
    blocks = (cfg.N_iters - 1) // every
    if sorted(evals) != [every * (i + 1) for i in range(blocks)] or \
            len(result.history) != blocks:
        fail(f'{label}: evals at {sorted(evals)}, {len(result.history)} '
             'logged blocks')
    missing = [k for k in must_launch if launches.get(k, 0) <= 0]
    if missing:
        fail(f'{label}: kernels never launched: {missing}')
    return launches, result.history, peak, final


def same_up_to_ties(got, want, grids, w):
    """Two detections (angles, periods, shifts) agree: the same groups, and
    in each the same shifts (angles and periods then within 1e-6), or
    shifts whose losses tie within 1e-5 of the grid's largest magnitude
    on every grid of `grids` (the FFTs' rounding decides such ties).
    Returns the number of tied groups, or None if they disagree."""
    import numpy as np
    (a_t, p_t, s_t), (a_w, p_w, s_w) = got, want
    if len(s_t) != len(s_w):
        return None
    ties = 0
    for i in range(len(s_w)):
        if np.array_equal(np.asarray(s_t[i]), np.asarray(s_w[i])):
            if not (np.allclose(a_t[i], a_w[i], rtol=0, atol=1e-6) and
                    np.allclose(p_t[i], p_w[i], rtol=0, atol=1e-6)):
                return None
            continue
        ties += 1
        for st, sw in zip(s_t[i], s_w[i]):
            (xt, yt), (xw, yw) = (np.asarray(st) / 4).astype(int), \
                (np.asarray(sw) / 4).astype(int)
            for g in grids:
                if abs(g[yt, xt + w] - g[yw, xw + w]) > \
                        1e-5 * np.abs(g).max():
                    return None
    return ties


def check_search_detection():
    """Detection at the default SearchConfig on the flagship image with its
    loss grid on the card (cuFFT) and on the CPU: the same candidates up
    to proven ties. Returns the CPU detection and the pseudo-split."""
    import numpy as np
    import torch
    from npp_tpu_torch.config import SearchConfig
    from npp_tpu_torch.proposal import features, search_engine
    from npp_tpu_torch.proposal.pseudo_mask import build_pseudo_split
    from npp_tpu_torch.utils.synthetic import synthetic_search_data
    cfg = SearchConfig()
    d = synthetic_search_data(0)
    img = np.uint8(d['masked_img'] * 255)
    mask = np.uint8(d['valid_mask'] * d['unknown_mask'])[..., 0]
    dets = {name: search_engine.search_periodicity_by_feat(
        img, mask, repeat_range=cfg.search_range, device=torch.device(name))
        for name in ('cuda', 'cpu')}
    act, m = features.im2act(img, mask)
    act = act * features.act2edge(act[:-1], m)[[0]]
    grids = [search_engine.displacement_loss_grid(
        torch.tensor(act[:-1], dtype=torch.float32, device=name),
        torch.tensor(m, dtype=torch.float32, device=name)).cpu().numpy()
        for name in ('cuda', 'cpu')]
    grid_err = float(np.abs(grids[0] - grids[1]).max() /
                     np.abs(grids[1]).max())
    ties = same_up_to_ties(dets['cuda'], dets['cpu'], grids, m.shape[1])
    log(f'search detection: {len(dets["cpu"][0])} candidates on the CPU, '
        f'{len(dets["cuda"][0])} with the grid on the card; grid rel diff '
        f'{grid_err:.2e}; tied groups {ties}')
    if ties is None:
        fail('search detection on the card disagrees with the CPU beyond '
             'ties')
    _, i_train, _ = build_pseudo_split(d['unknown_mask'], d['valid_mask'])
    return dets['cpu'], i_train, d['masked_img']


def check_search_step(det, i_train, img):
    """One lockstep ranking step of the default SearchConfig (9 candidates,
    depth 4, width 256, N_rand 2048) with the same parameters and batch on
    the card (K2 batched, one K4 launch each way) and on the CPU (plain
    versions), matmul_precision='float32': loss and every gradient agree."""
    import numpy as np
    import torch
    from npp_tpu_torch.config import SearchConfig, replace
    from npp_tpu_torch.device import matmul_precision
    from npp_tpu_torch.nn.embedder import gaussian_freq_bands
    from npp_tpu_torch.proposal import ranking
    cfg = replace(SearchConfig(), matmul_precision='float32')
    angles, periods, _ = det
    gen = torch.Generator().manual_seed(7)
    bands = gaussian_freq_bands(gen, cfg.multires)
    pix = torch.as_tensor(i_train)[torch.randint(
        0, len(i_train), (cfg.N_rand,), generator=gen)]
    res = {}
    for name in ('cpu', 'cuda'):
        dev = torch.device(name)
        params = ranking.init_rank_params(cfg, len(angles), dev)
        with torch.no_grad():    # latents away from 0: alpha != 1
            params.adaptive_pix.latent_alpha.copy_(torch.linspace(
                -2, 2, params.adaptive_pix.latent_alpha.numel()).reshape(
                params.adaptive_pix.latent_alpha.shape))
        lat = ranking.Lattices(cfg, angles, periods, bands, img.shape[:2],
                               dev)
        im = torch.as_tensor(img, dtype=torch.float32, device=dev)
        p = pix.to(dev)
        with matmul_precision(cfg.matmul_precision):
            loss = ranking.rank_loss(params, lat, p.float(),
                                     im[p[:, 0], p[:, 1]])
            loss.backward()
        res[name] = (loss.detach().cpu(),
                     {k: q.grad.cpu() for k, q in params.named_parameters()})

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    l_err = rel(res['cuda'][0], res['cpu'][0])
    g_err = max(rel(res['cuda'][1][k], v) for k, v in res['cpu'][1].items())
    log(f'search step card vs CPU: loss {float(res["cuda"][0]):.6f} vs '
        f'{float(res["cpu"][0]):.6f} (rel {l_err:.2e}), worst gradient rel '
        f'err {g_err:.2e} over {len(res["cpu"][1])} tensors')
    if not (l_err < 1e-4 and g_err < 1e-2 and np.isfinite(g_err)):
        fail('search step on the card disagrees with the CPU')


def drive_search():
    """run_search at the default SearchConfig on the flagship image (its
    lattices not given), on the card, save=False, every launch count set
    to 0 just before and read just after. Fails unless 9 candidates are
    ranked, the fit's losses are finite and fall, every score is finite,
    and the fit ran K2 batched and one K4 launch each way per step."""
    import numpy as np
    import torch
    from npp_tpu_torch.config import SearchConfig
    from npp_tpu_torch.kernels import launch_counts, reset_launches
    from npp_tpu_torch.proposal.search import run_search
    from npp_tpu_torch.utils.synthetic import synthetic_search_data
    cfg = SearchConfig()
    data = synthetic_search_data(0)
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    odgt = run_search(cfg, device='cuda', data=data, save=False, stats=stats)
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = np.asarray(stats['fit_losses'])
    cands = odgt['rank_candidates']
    log(f"search: detect {stats['detect_s']:.2f} s, rank "
        f"{stats['rank_s']:.2f} s (fit {stats['fit_s']:.2f} s, "
        f"{stats['fit_ms_per_step']:.2f} ms/step; eval "
        f"{stats['eval_s']:.2f} s: render {stats['eval_render_s']:.3f}, "
        f"LPIPS {stats['eval_lpips_s']:.3f}, CX {stats['eval_cx_s']:.3f} s "
        f"at {stats['cx_positions']} positions in groups of "
        f"{stats['cx_group']}, crop {stats['crop']}), artefacts "
        f"{stats['artefacts_s']:.3f} s; peak memory allocated "
        f"{peak / 2**30:.2f} GiB")
    log(f'search: fit loss {losses[0]:.5f} -> {losses[-1]:.5f}; distances '
        f"(detection order) {cands['scores']['reference']}")
    for i in range(3):
        log(f"search: top-{i + 1}: shifts {odgt['selected_shifts'][i]}, "
            f"angles {odgt['selected_angles'][i]}, periods "
            f"{odgt['selected_periods'][i]}, distance "
            f"{odgt['distances'][i]:.5f}")
    log(f'search: launches {dict(launches)}')
    scores = [v for s in cands['scores'].values() for v in s] + \
        [v for c in cands['components'].values() for v in c]
    if len(cands['angles']) != 9:
        fail(f"search: {len(cands['angles'])} candidates, not 9")
    if not (np.all(np.isfinite(losses)) and
            losses[-10:].mean() < losses[:10].mean()):
        fail(f'search: fit losses not finite or not falling: {losses}')
    if not np.all(np.isfinite(scores)):
        fail('search: non-finite scores')
    n, m = cfg.N_iters, SEARCH_K4
    want = {f'robust_rho_fwd[{m[0]}x{m[1]}]': n,
            f'robust_rho_bwd[{m[0]}x{m[1]}]': n}
    for (b, r, w), per_step in zip(SEARCH_K2, (cfg.netdepth, 1)):
        for k in ('fwd', 'bwd'):
            want[f'bias_snake_{k}[{b}x{r}x{w}]'] = per_step * n
    wrong = {k: launches.get(k, 0) for k, v in want.items()
             if launches.get(k, 0) != v}
    # the eval's CX: K3's forward only (no gradient), at the search shape
    cx = k3_name('fwd', *K3_SEARCH)
    if wrong or launches.get(cx, 0) <= 0 or launches.get('cx_chain_bwd', 0):
        fail(f'search: launch counts {wrong}, expected {want}; K3 '
             f"{ {k: v for k, v in launches.items() if 'cx' in k} }, "
             f'expected {cx} and no backward')
    return odgt, stats, launches, peak


def search_names():
    """The kernel entries of the search path (named like its launch
    counts)."""
    names = [f'bias_snake_{k}[{"x".join(map(str, sh))}]'
             for sh in SEARCH_K2 for k in ('fwd', 'bwd')]
    m, c = SEARCH_K4
    return names + [f'robust_rho_fwd[{m}x{c}]', f'robust_rho_bwd[{m}x{c}]']


def chained_data(odgt):
    """The flagship example with the search's top-3 lattices (read as the
    completion loader reads a record) in place of its own, and the patch
    size that follows from them."""
    from npp_tpu_torch.config import CompletionConfig
    from npp_tpu_torch.models.loaders import _topk_periodicity
    from npp_tpu_torch.utils.io import patch_size_from_periods
    from npp_tpu_torch.utils.synthetic import synthetic_data
    cfg = CompletionConfig()
    shifts, angles, periods = _topk_periodicity(odgt, cfg.p_topk,
                                                cfg.aux_gate_ratio)
    data = synthetic_data(0)
    data.selected_shifts, data.selected_angles = shifts, angles
    data.selected_periods = periods
    data.patch_size = patch_size_from_periods(periods)
    return data


def drive_heldout():
    """The completion with comp_heldout=2 and comp_snapshot='best', 11
    steps with milestones at 5 and 10: every eval and the final carry
    heldout_psnr, and the snapshot is a milestone."""
    _, history, _, final = drive(
        'held-out path', ['periodic_embed', 'bias_snake_fwd',
                          'bias_snake_bwd', 'robust_rho_fwd',
                          'robust_rho_bwd', *sorted(k3_names(K3_FIT))],
        N_iters=11, every=5, comp_heldout=2, comp_snapshot='best')
    log(f"held-out path: heldout_psnr {final.get('heldout_psnr')} at "
        f"snapshot_iter {final['snapshot_iter']}")
    if final['snapshot_iter'] not in (5, 10) or \
            not final.get('heldout_psnr', float('nan')) > 0:
        fail('held-out path: no held-out PSNR or no milestone snapshot')
    return dict(ms_per_step=[h['ms_per_step'] for h in history],
                heldout_psnr=final['heldout_psnr'],
                snapshot_iter=final['snapshot_iter'],
                train_psnr=final['train_psnr'], val_psnr=final['val_psnr'])


def drive_warp():
    """The completion with warp_field=True, 11 steps (one block of 10): K1
    embeds the warped coordinates on the fly (no table: at least one
    forward launch a step) and its backward runs once a step."""
    launches, history, _, final = drive(
        'warp path', ['periodic_embed', 'periodic_embed_bwd',
                      'bias_snake_fwd', 'bias_snake_bwd', 'robust_rho_fwd',
                      'robust_rho_bwd', *sorted(k3_names(K3_FIT))], N_iters=11,
        warp_field=True)
    steps = 10
    if launches['periodic_embed'] < steps or \
            launches['periodic_embed_bwd'] != steps:
        fail(f"warp path: K1 launched {launches['periodic_embed']} times "
             f"forward and {launches['periodic_embed_bwd']} backward in "
             f"{steps} steps")
    return launches, dict(ms_per_step=[h['ms_per_step'] for h in history],
                          train_psnr=final['train_psnr'],
                          val_psnr=final['val_psnr'])


# the segmentation path: the 256x320 synthetic example's canvas (K1's
# table), its step rows (N_rand 8192 + 2 fake 64^2 patches) at width 512
SEG_K1_ROWS = 256 * 320
SEG_K2 = (8192 + 2 * 64 * 64, 512)
SEG_K2_NAMES = tuple(f'bias_snake_{k}[{SEG_K2[0]}x{SEG_K2[1]}]'
                     for k in ('fwd', 'bwd'))


def check_k1_seg(gen):
    """K1 in f32 at the segmentation canvas's table (256*320 rows, the
    example's three lattices, 1386 channels), judged against the plain
    version in f32 and float64."""
    import torch
    from npp_tpu_torch.kernels.periodic_embed import (periodic_embed,
                                                      periodic_embed_plain)
    from npp_tpu_torch.utils.synthetic import synthetic_segment_data
    h, w = 256, 320
    arr = synthetic_segment_data(0, h, w)
    dev = torch.device('cuda')
    ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing='ij')
    coords = torch.stack([ys, xs], -1).reshape(-1, 2).float()
    args = (coords, torch.tensor(arr['selected_angles'], device=dev).float(),
            torch.tensor(arr['selected_periods'], device=dev).float(),
            (torch.randn(10, generator=gen) * 10).to(dev), (1.0,),
            (0.0, -1.0, 1.0, 0.5, -0.5), (0.0,), (h, w))
    got = periodic_embed(*args)
    want = periodic_embed_plain(*args)
    want64 = periodic_embed_plain(*[a.double() if torch.is_tensor(a) else a
                                    for a in args])
    torch.cuda.synchronize()
    if got.shape != (SEG_K1_ROWS, 1386):
        fail(f'K1 output {tuple(got.shape)} at the segmentation canvas')
    err = judge([(got, want, want64)])
    del got, want, want64
    n_out = SEG_K1_ROWS * 1386
    b_ms, b_by = bound_ms(coords.numel() * 4 + n_out * 4, n_out * 20)
    return [dict(
        name=f'periodic_embed[{SEG_K1_ROWS}x1386]', route='cuda',
        source='npp_tpu_torch/csrc/periodic_embed.cu',
        replaces='npp_tpu/nn/embedder.py:149 (TaskEmbedder.embed, XLA-fused; '
                 'no pl.pallas_call in the repo)',
        shape=[SEG_K1_ROWS, 1386], dtype='float32', **err,
        **device_times(lambda: periodic_embed(*args)),
        eager_ms=eager_ms(lambda: periodic_embed(*args)),
        plain_ms=time_ms(lambda: periodic_embed_plain(*args), iters=5),
        bound_ms=b_ms, bound_us=1e3 * b_ms, bound_by=b_by, library_ms=None)]


def seg_names():
    """The kernel entries of the segmentation path (named like its launch
    counts)."""
    return {f'periodic_embed[{SEG_K1_ROWS}x1386]', *SEG_K2_NAMES}


def check_slic():
    """SLIC of the 256x320 segmentation example (the loader's sp_size 20,
    regularisation 0.1) with its local k-means on the card, twice, and on
    the CPU: the two card runs give the same labels, and the card's agree
    with the CPU's on at least 99.9% of the pixels (f32 distance ties may
    fall either way)."""
    import numpy as np
    import torch
    from npp_tpu_torch.segmentation.slic import slic_segment
    from npp_tpu_torch.utils.synthetic import synthetic_segment_data
    img = np.uint8(synthetic_segment_data(0)['gt_img'] * 255)
    runs = {}
    for name in ('cuda', 'cuda', 'cpu'):
        torch.cuda.synchronize()
        t0 = time.time()
        lab = slic_segment(img, sp_size=20, relative_compact=0.1,
                           device=torch.device(name))
        runs.setdefault(name, []).append((lab, time.time() - t0))
    (a, t_a), (b, t_b) = runs['cuda']
    cpu, t_cpu = runs['cpu'][0]
    same = bool(np.array_equal(a, b))
    agree = float((a == cpu).mean())
    log(f'SLIC 256x320 on the card: {a.max()} superpixels, repeat run '
        f'identical: {same}; agrees with the CPU on {agree:.6f} of pixels; '
        f'{t_a:.3f} s (first), {t_b:.3f} s (second) on the card, '
        f'{t_cpu:.3f} s on the CPU')
    if not (same and agree >= 0.999):
        fail('SLIC on the card is not deterministic or disagrees with the CPU')
    return dict(identical_repeat=same, cpu_agreement=agree,
                superpixels=int(a.max()), card_s=[t_a, t_b], cpu_s=t_cpu)


def check_seg_step():
    """One segmentation step (the blurred image as pixel source, period
    mask x valid as the sampler's mask) on the 96x128 example's loader data
    with patch 32, card against CPU in f32."""
    import torch
    from npp_tpu_torch.config import SegmentationConfig, replace
    from npp_tpu_torch.models.loaders import segmentation_data
    from npp_tpu_torch.models.segmentation import SEGMENTATION_TASK
    from npp_tpu_torch.utils.synthetic import synthetic_segment_data
    cfg = replace(SegmentationConfig(), netwidth=64, netdepth=6, N_rand=512,
                  patch_num=1, num_real_patch_per_sample=2,
                  matmul_precision='float32')
    data = segmentation_data(synthetic_segment_data(0, 96, 128), cfg,
                             torch.device('cpu'))
    data.patch_size = 32
    return check_step('segmentation step', cfg, data, SEGMENTATION_TASK,
                      want=lambda b: float(b.valid.sum()) == 2)


def iou(a, b):
    import numpy as np
    a, b = np.asarray(a, bool), np.asarray(b, bool)
    u = (a | b).sum()
    return float((a & b).sum() / u) if u else 1.0


def drive_segment():
    """run_segmentation on the 256x320 synthetic example at the default
    SegmentationConfig widths, 21 iterations with refinements at 10 and
    20, every launch count set to 0 just before and read just after. Fails
    on non-finite losses or maps, missing refinements, or a kernel of the
    path that never launched: K1 (the canvas table), K2 at the step's
    16,384 x 512, K4's forward and backward at the pixel loss's 8,192 x 3.
    Reports the IoU of the coarse and the refined non-periodic masks
    against the example's ground truth."""
    import numpy as np
    import torch
    from npp_tpu_torch.config import SegmentationConfig, replace
    from npp_tpu_torch.kernels import launch_counts, reset_launches
    from npp_tpu_torch.models.segmentation import run_segmentation
    from npp_tpu_torch.utils.synthetic import synthetic_segment_data
    cfg = replace(SegmentationConfig(), N_iters=21, i_testset=10, i_print=10)
    arrays = synthetic_segment_data(0)
    gt = arrays['gt_mask']
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    result, results, data = run_segmentation(cfg, save=False, device='cuda',
                                             data=arrays)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    oh, ow = data.orig_shape
    init = data.extra['non_period_mask'][:oh, :ow, 0] > 0
    ious = {i: iou(r['non_period_mask'][..., 0] > 0, gt)
            for i, r in sorted(results.items())}
    for h in result.history:
        log(f"segmentation path: block ending at iter {h['iter']}: loss "
            f"{h['loss']:.6g} (contextual {h['contextual']:.6g}), "
            f"{h['ms_per_step']:.2f} ms/step")
    log(f'segmentation path: patch size {data.patch_size}; IoU against the '
        f'ground truth: coarse init {iou(init, gt):.4f}, refined '
        f'{ious} (by iteration); non-periodic fraction: gt '
        f'{gt.mean():.4f}, init {init.mean():.4f}')
    log(f'segmentation path: {wall:.1f} s wall (coarse mask and fit '
        f'{result.wall_time_s:.1f} s fit); peak memory allocated '
        f'{peak / 2**30:.2f} GiB; launches {launches}')
    numbers = [h['loss'] for h in result.history] + \
        [float(np.max(m)) for r in results.values()
         for m in r['lpips_maps'] + [r['l1_img']]]
    if not np.all(np.isfinite(numbers)):
        fail(f'segmentation path: non-finite losses or maps: {numbers}')
    if sorted(results) != [10, 20] or not 0 < init.mean() < 1:
        fail(f'segmentation path: refinements at {sorted(results)}, init '
             f'fraction {init.mean()}')
    need = [*sorted(seg_names()), 'robust_rho_fwd[8192x3]',
            'robust_rho_bwd[8192x3]', *sorted(k3_names(K3_PATCH64))]
    missing = [k for k in need if launches.get(k, 0) <= 0]
    if missing:
        fail(f'segmentation path: kernels never launched: {missing}')
    return launches, dict(
        ms_per_step=[h['ms_per_step'] for h in result.history],
        iou_init=iou(init, gt), iou_refined=ious, wall_s=wall,
        fit_wall_s=result.wall_time_s, peak_bytes=peak,
        patch_size=data.patch_size)


# ---- the multi-image path: K1 batched, the batched step and fit_images,
# the suite search, and the entry points a user runs from files

# a completion step's rows per image (N_rand + two 160^2 fake patches)
BATCH_ROWS = 8192 + 2 * 160 * 160
# three flagship images: their f32 tables (3.27 GB) exceed the default
# embed_table_max_mb, so K1 runs on the fly every step; two images' bf16
# tables (1.09 GB) are built in one launch per block
BATCH_K1 = (3, BATCH_ROWS)
BATCH_K1_BF16 = (2, 384 * 512)
BATCH_K2 = (3, BATCH_ROWS, 512)
BATCH_K4_PIXEL = (8192, 9)
# the suite search: 3 images x 9 candidates in lockstep
SUITE_K2 = [(27, 2048, 256), (27, 2048, 128)]
SUITE_K4 = (2048, 81)
# the suite's distances under TF32 against the sequential searches': the
# spread of two sequential runs, or this relative bar (H100 readings: up
# to 3.1e-3; in full f32 the bar is 1e-3 and the readings 1.3e-5)
SUITE_TF32_BAR = 1e-2
K1_REPLACES = ('npp_tpu/nn/embedder.py:149 (TaskEmbedder.embed, vmapped '
               'over images by npp_tpu/parallel/batch.py:60-72, XLA-fused{}; '
               'no pl.pallas_call in the repo)')


def batch_k1_names():
    b, n = BATCH_K1
    return {f'periodic_embed_batched[{b}x{n}x1386]',
            'periodic_embed_batched_bf16[{}x{}x1386]'.format(*BATCH_K1_BF16),
            'periodic_embed_batched_bwd'}


def batch_names():
    """The kernel entries of the batched fit's paths."""
    m, c = BATCH_K4_PIXEL
    return batch_k1_names() | {
        f'bias_snake_{k}[{"x".join(map(str, BATCH_K2))}]'
        for k in ('fwd', 'bwd')} | {f'robust_rho_fwd[{m}x{c}]',
                                    f'robust_rho_bwd[{m}x{c}]',
                                    batch_lpips_group_name()}


def batch_lpips_group_name():
    """The batched step's LPIPS K4 launch: a segment per (layer, image)."""
    shapes = [sh for sh in K4_LPIPS for _ in range(3)]
    return 'robust_rho_fwd_group[{}]'.format(
        ','.join(f'{m}x{c}' for m, c in shapes))


def suite_names():
    m, c = SUITE_K4
    return {f'bias_snake_{k}[{"x".join(map(str, sh))}]'
            for sh in SUITE_K2 for k in ('fwd', 'bwd')} | \
        {f'robust_rho_fwd[{m}x{c}]', f'robust_rho_bwd[{m}x{c}]'}


def k1_batched_inputs(gen, b, n, jitter):
    """B images of the flagship's lattices, each with its periods and dims
    moved (so no two images share K1's constants), n integer canvas
    coordinates per image (plus a uniform jitter of up to +-3 px, as warped
    coordinates have, when `jitter`)."""
    import torch
    from npp_tpu_torch.utils.synthetic import H, W, synthetic_data
    data = synthetic_data(0)
    dev = torch.device('cuda')
    ang = torch.tensor(data.selected_angles).float()
    per = torch.tensor(data.selected_periods).float()
    angles = torch.stack([ang + 3.0 * j for j in range(b)]).to(dev)
    periods = torch.stack([per * (1.0 + 0.07 * j) for j in range(b)]).to(dev)
    res = torch.tensor([[H - 32.0 * j, W - 64.0 * j] for j in range(b)],
                       device=dev)
    if n == H * W:
        ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W),
                                indexing='ij')
        one = torch.stack([ys, xs], -1).reshape(-1, 2).float()
        coords = one.expand(b, -1, -1).contiguous()
    else:
        coords = torch.stack([torch.randint(0, H, (b, n), generator=gen),
                              torch.randint(0, W, (b, n), generator=gen)],
                             -1).float()
    if jitter:
        coords = coords + (torch.rand(coords.shape, generator=gen) - 0.5) * 6
    bands = torch.randn(10, generator=gen) * 10
    return (coords.to(dev), angles, periods, bands.to(dev), (1.0,),
            (0.0, -1.0, 1.0, 0.5, -0.5), (0.0,), res)


def check_k1_batched(gen):
    """K1's batched entries: the forward in f32 at the on-the-fly shape
    (3 x 59,392 rows) against the plain version in f32 and float64; in
    bf16 at two flagship tables (2 x 196,608), which must be the batched f32
    kernel's output rounded to nearest even and within one bf16 ulp of the
    plain f32; the backward in the coordinates at 3 x 59,392 (warped,
    fractional coordinates) against autograd through the plain version in
    f32 and float64. Each image has its own proposals and dims."""
    import torch
    from npp_tpu_torch.kernels import periodic_embed as pe
    out = []
    src = 'npp_tpu_torch/csrc/periodic_embed.cu'
    for (b, n), dtype in ((BATCH_K1, torch.float32),
                          (BATCH_K1_BF16, torch.bfloat16)):
        args = k1_batched_inputs(gen, b, n, False)
        want = pe.periodic_embed_batched_plain(*args)
        got32 = pe.periodic_embed_batched(*args)
        torch.cuda.synchronize()
        if got32.shape != (b, n, 1386):
            fail(f'K1 batched output {tuple(got32.shape)}')
        if dtype == torch.float32:
            want64 = pe.periodic_embed_batched_plain(
                *[a.double() if torch.is_tensor(a) else a for a in args])
            err = judge([(got32, want, want64)])
            del want64
            name = f'periodic_embed_batched[{b}x{n}x1386]'
        else:
            got = pe.periodic_embed_batched(*args, out_dtype=dtype)
            torch.cuda.synchronize()
            rounded = torch.equal(got, got32.to(dtype))
            ulps = bf16_ulps(got, want.to(dtype), 1e-5)
            err = dict(max_abs_err=float((got.float() - want).abs().max()),
                       max_bf16_ulps=ulps, equals_f32_kernel_rounded=rounded,
                       passed=ulps <= 1.0 and rounded)
            del got
            name = f'periodic_embed_batched_bf16[{b}x{n}x1386]'
        del got32, want
        n_out = b * n * 1386
        b_ms, b_by = bound_ms(b * n * 2 * 4 + n_out * dtype.itemsize,
                              n_out * 20)
        out.append(dict(
            name=name, route='cuda', source=src,
            replaces=K1_REPLACES.format(
                '' if dtype == torch.float32 else
                ', and the tables\' .astype(dtype), embedder.py:235'),
            shape=[b, n, 1386], dtype=str(dtype).split('.')[-1], **err,
            **device_times(lambda: pe.periodic_embed_batched(
                *args, out_dtype=dtype)),
            eager_ms=eager_ms(lambda: pe.periodic_embed_batched(
                *args, out_dtype=dtype)),
            plain_ms=time_ms(lambda: pe.periodic_embed_batched_plain(
                *args, out_dtype=dtype), iters=3),
            bound_ms=b_ms, bound_us=1e3 * b_ms, bound_by=b_by,
            library_ms=None))
        torch.cuda.empty_cache()

    b, n = BATCH_K1
    args = k1_batched_inputs(gen, b, n, True)
    coords = args[0]
    g = torch.randn(b, n, 1386, generator=gen).to(coords.device)
    ck = coords.clone().requires_grad_()
    pe.periodic_embed_batched(ck, *args[1:]).backward(g)
    cp = coords.clone().requires_grad_()
    pe.periodic_embed_batched_plain(cp, *args[1:]).backward(g)
    cd = coords.double().requires_grad_()
    pe.periodic_embed_batched_plain(
        cd, *[a.double() if torch.is_tensor(a) else a for a in args[1:]]
    ).backward(g.double())
    torch.cuda.synchronize()
    err = judge([(ck.grad, cp.grad, cd.grad)])
    del cd
    a = pe._Args(*args)

    def plain_bwd():
        c = coords.detach().requires_grad_()
        return torch.autograd.grad(pe.periodic_embed_batched_plain(
            c, *args[1:]), c, g)
    # g (B, N, 1386) and the coordinates read, dcoords written
    b_ms, b_by = bound_ms((b * n * 1386 + 4 * b * n) * 4, b * n * 1386 * 24)
    out.append(dict(
        name='periodic_embed_batched_bwd', route='cuda', source=src,
        replaces=K1_REPLACES.format(', its gradient in the coordinates '
                                    'under the warp field'),
        shape=[b, n, 1386], dtype='float32', **err,
        **device_times(lambda: pe.periodic_embed_bwd_batched_launch(g, coords, a)),
        eager_ms=eager_ms(lambda: pe.periodic_embed_bwd_batched_launch(
            g, coords, a)),
        plain_ms=time_ms(plain_bwd, iters=3),
        bound_ms=b_ms, bound_us=1e3 * b_ms, bound_by=b_by, library_ms=None))
    return out


def check_batch_kernels(gen):
    """K2 and K4 at the batched paths' new shapes: K2 at the batched step's
    (3, 59,392, 512) and the suite's (27, 2,048, 256 / 128); K4 at the
    batched pixel loss's 8,192 x 9 and the suite's 2,048 x 81 both ways,
    and the batched LPIPS group (a segment per layer and image, 15)."""
    import torch
    from npp_tpu_torch.kernels import robust_rho as rr
    out = []
    for shape in [BATCH_K2] + SUITE_K2:
        key = 'x'.join(map(str, shape))
        out += k2_entries(gen, shape, (f'bias_snake_fwd[{key}]',
                                       f'bias_snake_bwd[{key}]'))
    for m, c in (BATCH_K4_PIXEL, SUITE_K4):
        err = judge_k4_fwd(gen, [(m, c)])
        x, alpha, scale, w = k4_inputs(gen, m, c, 'spread')
        out.append(k4_entry(
            f'robust_rho_fwd[{m}x{c}]', FWD_SRC, [m, c], err,
            lambda: rr.rho_fwd_launch(x, alpha, scale, w),
            lambda: rr.rho_rows_plain(x, alpha, scale, w),
            *fwd_bytes_ops(m, c)))
        out.append(k4_bwd_entry(gen, m, c, K4_ALPHAS))
    shapes = [sh for sh in K4_LPIPS for _ in range(3)]
    err = judge_k4_fwd(gen, shapes)
    segs = [k4_inputs(gen, m, c, 'spread') for m, c in shapes]
    n_bytes, ops = (sum(v) for v in zip(*[fwd_bytes_ops(m, c)
                                          for m, c in shapes]))
    out.append(k4_entry(
        batch_lpips_group_name(), FWD_SRC, [list(sh) for sh in shapes], err,
        lambda: rr.rho_fwd_group_launch(segs),
        lambda: rr.rho_rows_group_plain(*zip(*segs)), n_bytes, ops))
    torch.cuda.empty_cache()
    return out


def check_batched_step():
    """One batched completion step of three images (every loss on, each
    image on its own injected 'same' batch, matmul_precision='float32')
    against the same three single-image steps on the card: the loss (the
    sum of the three) within 1e-5 relative, every gradient within 1e-4 of
    its tensor's largest value (batched GEMMs and convolutions over three
    times the patches reassociate)."""
    import numpy as np
    import torch
    from npp_tpu_torch.config import CompletionConfig, replace
    from npp_tpu_torch.models.pipeline import build_components, make_fit_consts
    from npp_tpu_torch.models.sampler import SOURCE_SAME
    from npp_tpu_torch.models.trainer import build_loss_fn, init_fit_state
    from npp_tpu_torch.nn.embedder import make_task_embedder
    from npp_tpu_torch.parallel import batch as pb
    from npp_tpu_torch.utils.synthetic import synthetic_data
    cfg = replace(CompletionConfig(), netwidth=64, netdepth=6, N_rand=512,
                  patch_num=1, num_real_patch_per_sample=2,
                  matmul_precision='float32')
    dev = torch.device('cuda')
    datas = [synthetic_data(s, 96, 128) for s in (0, 1, 2)]
    for d in datas:
        d.patch_size = 32
    comps = build_components(cfg, datas[0], dev)
    consts = [make_fit_consts(cfg, d, 32, dev) for d in datas]
    gen = torch.Generator().manual_seed(3)
    inject = []
    for c in consts:
        b = draw_batch(gen, c.sampler, 1, 32, 2, 0.3,
                       lambda b: b.source == SOURCE_SAME)
        inject.append((torch.randint(0, c.pool_train_n, (cfg.N_rand,),
                                     generator=gen), b))
    embs = [make_task_embedder(cfg, np.asarray(d.selected_angles),
                               np.asarray(d.selected_periods),
                               d.img.shape[:2],
                               torch.Generator().manual_seed(cfg.seed), dev)
            for d in datas]
    state0 = init_fit_state(cfg, comps.model, comps.percep, dev)
    off = torch.Generator().manual_seed(4)
    with torch.no_grad():     # the latents off their init
        for k, v in state0.params.named_parameters():
            if 'latent' in k:
                v.copy_(0.3 * torch.randn(v.shape, generator=off).to(dev))
    state_b = pb.init_batched_state(cfg, state0, 3)
    emb_b = pb.stack_embedders(embs)
    loss_fn = pb.build_batched_loss_fn(
        cfg, comps.percep, comps.contextual, 1, 32,
        inject=([p for p, _ in inject], [b for _, b in inject]),
        res=emb_b.res)
    loss_b, _ = loss_fn(state_b.params, emb_b, pb.stack_consts(consts), None)
    loss_b.backward()
    losses, g_err = [], {}
    for j in range(3):
        single = pb.unstack_params(state_b.params, state0.params, j)
        for p in single.parameters():
            p.grad = None
        fn = build_loss_fn(cfg, comps.percep, comps.contextual, 1, 32,
                           inject=inject[j])
        loss, _ = fn(single, embs[j], consts[j], None)
        loss.backward()
        losses.append(float(loss.detach()))
        for sp, tp, tr in pb._param_pairs(state_b.params, single):
            want = tp.grad if tp.grad is not None else torch.zeros_like(tp)
            got = pb._piece(sp.grad, j, tr)
            e = float((got - want).abs().max()) / \
                max(float(want.abs().max()), 1e-30)
            key = f'{j}:{tuple(tp.shape)}'
            g_err[key] = max(g_err.get(key, 0.0), e)
    torch.cuda.synchronize()
    l_err = abs(float(loss_b.detach()) - sum(losses)) / abs(sum(losses))
    worst = max(g_err, key=g_err.get)
    log(f'batched step (3 images) vs three single steps on the card: loss '
        f'{float(loss_b.detach()):.6f} vs {sum(losses):.6f} (rel '
        f'{l_err:.2e}), worst gradient rel err {g_err[worst]:.2e} ({worst})')
    if not (l_err <= 1e-5 and g_err[worst] <= 1e-4):
        fail('the batched step disagrees with the single steps')
    return dict(loss_rel_err=l_err, worst_grad_rel_err=g_err[worst],
                worst_grad=worst)


def _device_ms(prof):
    import torch
    total = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, 'self_device_time_total', None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            total += us / 1e3
    return total


class BlockProfile:
    """Profiles the block between the hooks at `start` and `stop` (fit
    iterations): device ms and wall ms of that block."""

    def __init__(self, start, stop):
        self.start, self.stop, self.prof = start, stop, None
        self.device_ms = self.wall_ms = None

    def __call__(self, i, *_):
        import torch
        from torch.profiler import ProfilerActivity, profile
        if i == self.start:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.time()
        elif i == self.stop and self.prof is not None:
            torch.cuda.synchronize()
            self.wall_ms = 1e3 * (time.time() - self.t0)
            self.prof.__exit__(None, None, None)
            self.device_ms = _device_ms(self.prof)


def drive_batched():
    """fit_images on three flagship images (utils/synthetic.py seeds 0-2,
    384x512, one bucket) at the default CompletionConfig, 21 iterations,
    every launch count set to 0 just before and read just after: K1's
    batched forward every step (the three f32 tables exceed
    embed_table_max_mb), K2 at (3, 59,392, 512), K4's pixel loss at
    8,192 x 9. Then its steady block under the profiler (device time,
    busy share) and a sequential fit_image of image 0 the same way; then
    two images with embed_table='bfloat16' (both tables in one K1 launch)
    and three with the warp field (K1's batched backward every step)."""
    import numpy as np
    import torch
    from npp_tpu_torch.config import CompletionConfig, replace
    from npp_tpu_torch.device import matmul_precision
    from npp_tpu_torch.kernels import launch_counts, reset_launches
    from npp_tpu_torch.models.completion import evaluate
    from npp_tpu_torch.models.pipeline import fit_image
    from npp_tpu_torch.models.trainer import COMPLETION_TASK
    from npp_tpu_torch.parallel.runner import fit_images
    from npp_tpu_torch.utils.synthetic import synthetic_data
    cfg = replace(CompletionConfig(), N_iters=21, i_testset=10, i_print=10)
    datas = [synthetic_data(s) for s in (0, 1, 2)]
    out, runs = {}, {}

    def run(label, cfg_, datas_, **kw):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        stats = {}
        t0 = time.time()
        states, ctxs = fit_images(cfg_, COMPLETION_TASK, datas_,
                                  return_ctx=True, device='cuda',
                                  stats=stats, **kw)
        runs.setdefault(label, []).append(host_params(states))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        psnr = []
        with matmul_precision('float32'):
            for d, st, ctx in zip(datas_, states, ctxs):
                e = evaluate(d, st.params, ctx['render'],
                             st.params.adaptive_pix, cfg_.loss_type,
                             torch.device('cuda'))
                psnr.append((e['train_psnr'], e['val_psnr']))
        log(f'{label}: {len(datas_)} images, {wall:.1f} s wall, buckets '
            f'{stats["buckets"]}; (train, val) PSNR {psnr}; peak memory '
            f'{peak / 2**30:.2f} GiB; launches {dict(launches)}')
        if not np.all(np.isfinite(psnr)) or len(stats['buckets']) != 1:
            fail(f'{label}: non-finite PSNR or not one bucket')
        return launches, dict(stats['buckets'][0], total_wall_s=wall,
                              peak_bytes=peak, psnr_train_val=psnr)

    launches, res = run('batched path', cfg, datas)
    steps = cfg.N_iters - 1
    b, n = BATCH_K1
    m, c = BATCH_K4_PIXEL
    want = {f'periodic_embed_batched[{b}x{n}x1386]': steps,
            f'robust_rho_fwd[{m}x{c}]': steps,
            f'robust_rho_bwd[{m}x{c}]': steps}
    wrong = {k: launches.get(k, 0) for k, v in want.items()
             if launches.get(k, 0) != v}
    key = 'x'.join(map(str, BATCH_K2))
    if wrong or launches.get(f'bias_snake_fwd[{key}]', 0) <= 0 or \
            launches.get('periodic_embed', 0) != 0 or \
            res['table'] is not None or \
            any(launches.get(k, 0) <= 0 for k in k3_names(K3_BATCHED)):
        fail(f'batched path: launch counts {wrong or dict(launches)}; '
             f'expected {want}, K2 at {key}, K3 at {K3_BATCHED} and no '
             'table')
    out['batched'] = dict(res, lpips_group_launches=launches.get(
        batch_lpips_group_name(), 0))
    all_launches = dict(launches)

    prof = BlockProfile(10, 20)
    runs['batched path'].append(host_params(fit_images(
        cfg, COMPLETION_TASK, datas, device='cuda', milestone_hook=prof)))
    out['batched'].update(profiled_device_ms_per_step=prof.device_ms / 10,
                          profiled_wall_ms_per_step=prof.wall_ms / 10,
                          busy_share=prof.device_ms / prof.wall_ms)
    torch.cuda.reset_peak_memory_stats()
    seq = fit_image(cfg, datas[0], log_every=cfg.i_print, device='cuda')
    seq_peak = torch.cuda.max_memory_allocated()
    sprof = BlockProfile(10, 20)
    fit_image(cfg, datas[0], eval_hook=sprof, log_every=cfg.i_print,
              device='cuda')
    out['sequential_image0'] = dict(
        ms_per_step=[h['ms_per_step'] for h in seq.history],
        peak_bytes=seq_peak,
        profiled_device_ms_per_step=sprof.device_ms / 10,
        profiled_wall_ms_per_step=sprof.wall_ms / 10,
        busy_share=sprof.device_ms / sprof.wall_ms)
    log(f"batched path: steady {res['ms_per_step_steady']:.2f} ms/step for "
        f"3 images (busy {out['batched']['busy_share']:.3f} profiled, "
        f"device {out['batched']['profiled_device_ms_per_step']:.2f} "
        f"ms/step); sequential image 0: {seq.history[-1]['ms_per_step']:.2f} "
        f"ms/step (busy {out['sequential_image0']['busy_share']:.3f}, device "
        f"{out['sequential_image0']['profiled_device_ms_per_step']:.2f})")

    launches, res = run('batched bf16-table path',
                        replace(cfg, N_iters=11, embed_table='bfloat16'),
                        datas[:2])
    bname = 'periodic_embed_batched_bf16[{}x{}x1386]'.format(*BATCH_K1_BF16)
    if launches.get(bname, 0) != 1 or res['table'] != 'bfloat16':
        fail(f'batched bf16-table path: {bname} launched '
             f'{launches.get(bname, 0)} times (table {res["table"]})')
    out['batched_bf16_table'] = res
    all_launches[bname] = launches[bname]

    wcfg = replace(cfg, N_iters=6, i_testset=5, i_print=5)
    launches, res = run('batched warp path', wcfg, datas,
                        per_image=[{'warp_field': True}] * 3)
    steps = wcfg.N_iters - 1
    if launches.get('periodic_embed_batched_bwd', 0) != steps or \
            launches.get(f'periodic_embed_batched[{b}x{n}x1386]', 0) < steps:
        fail(f'batched warp path: K1 batched {dict(launches)} in {steps} '
             'steps')
    out['batched_warp'] = res
    all_launches['periodic_embed_batched_bwd'] = \
        launches['periodic_embed_batched_bwd']
    return all_launches, out, runs['batched path']


def host_params(states):
    """Each FitState's named parameters as numpy arrays."""
    return [{k: v.detach().cpu().numpy()
             for k, v in st.params.named_parameters()} for st in states]


def _suite_against_sequential(cfgs, datas, odgts, label, bar):
    """Each image's sequential run_search, twice: the suite's top-3
    lattices must equal theirs; with `bar`, its distances must lie within
    the two runs' spread, or within `bar` relative where they repeat.
    Returns the walls and the distances."""
    import numpy as np
    import torch
    from npp_tpu_torch.proposal.search import run_search
    walls, report = [], []
    for cfg, d, rec in zip(cfgs, datas, odgts):
        runs = []
        for _ in range(2):
            t1 = time.time()
            runs.append(run_search(cfg, device='cuda', data=d, save=False))
            torch.cuda.synchronize()
            walls.append(time.time() - t1)
        for key in ('selected_shifts', 'selected_angles', 'selected_periods'):
            if rec[key][:3] != runs[0][key][:3] or \
                    rec[key][:3] != runs[1][key][:3]:
                fail(f'{label}: {cfg.datadir} {key} top-3 {rec[key][:3]} '
                     f'against sequential {runs[0][key][:3]} / '
                     f'{runs[1][key][:3]}')
        got = np.asarray(rec['distances'])
        d0, d1 = (np.asarray(r['distances']) for r in runs)
        rel = float(np.max(np.abs(got - d0) / np.abs(d0)))
        report.append(dict(suite=got.tolist(), seq=[d0.tolist(), d1.tolist()],
                           max_rel_diff=rel))
        if bar is not None:
            lo, hi = np.minimum(d0, d1), np.maximum(d0, d1)
            slack = bar * np.abs(d0)
            if not np.all((got >= lo - slack) & (got <= hi + slack)):
                fail(f'{label}: {cfg.datadir} distances {got} outside the '
                     f'sequential runs {d0} / {d1} (bar {bar})')
    return walls, report


def drive_suite_search():
    """run_search_suite on three synthetic_search_data images (seeds 0-2) at
    the default SearchConfig, every launch count set to 0 just before and
    read just after: K2 at (27, 2,048, 256 / 128) and K4 at 2,048 x 81, once
    each way per step. Then each image's sequential run_search twice: the
    suite's top-3 lattices must equal the sequential ones. The distances
    are held to the sequential runs' spread (or 1e-3 relative where those
    repeat) in full f32 (matmul_precision='float32', a second suite and
    its sequential runs). Under the default TF32 the stacked GEMMs of 27
    candidates round otherwise than those of 9, and 300 Adam steps carry
    that into the distances (3.1e-3 relative at most on an H100), so
    there they are held to the spread or SUITE_TF32_BAR relative."""
    import torch
    from npp_tpu_torch.config import SearchConfig, replace
    from npp_tpu_torch.kernels import launch_counts, reset_launches
    from npp_tpu_torch.proposal.search import run_search_suite
    from npp_tpu_torch.utils.synthetic import synthetic_search_data
    cfgs = [replace(SearchConfig(), datadir=f'suite{s}') for s in (0, 1, 2)]
    datas = [synthetic_search_data(s) for s in (0, 1, 2)]
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    odgts = run_search_suite(cfgs, device='cuda', datas=datas, save=False,
                             stats=stats)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n = cfgs[0].N_iters
    m, c = SUITE_K4
    want = {f'robust_rho_fwd[{m}x{c}]': n, f'robust_rho_bwd[{m}x{c}]': n}
    for (bb, r, w), per_step in zip(SUITE_K2, (cfgs[0].netdepth, 1)):
        for k in ('fwd', 'bwd'):
            want[f'bias_snake_{k}[{bb}x{r}x{w}]'] = per_step * n
    wrong = {k: launches.get(k, 0) for k, v in want.items()
             if launches.get(k, 0) != v}
    if wrong or launches.get('cx_chain_fwd', 0) <= 0:
        fail(f'suite search: launch counts {wrong}, expected {want} and '
             f"K3's forward in the eval")
    seq_walls, report = _suite_against_sequential(
        cfgs, datas, odgts, 'suite search', SUITE_TF32_BAR)
    log(f'suite search: 3 images in {wall:.2f} s (rank '
        f"{stats['rank_s']:.2f} s, fit {stats['fit_ms_per_step']:.2f} "
        f"ms/step) against sequential searches of "
        f"{', '.join(f'{w:.2f}' for w in seq_walls)} s; peak "
        f'{peak / 2**30:.2f} GiB; top-3 equal; distances within the '
        f"sequential runs' spread or {SUITE_TF32_BAR} (TF32): max rel diff "
        f"{[round(r['max_rel_diff'], 6) for r in report]}")
    f32 = [replace(cfg, matmul_precision='float32') for cfg in cfgs]
    odgts32 = run_search_suite(f32, device='cuda', datas=datas, save=False)
    _, report32 = _suite_against_sequential(f32, datas, odgts32,
                                            'suite search (f32)', 1e-3)
    log(f'suite search in full f32: top-3 equal, distances within the '
        f"sequential runs' spread or 1e-3: max rel diff "
        f"{[round(r['max_rel_diff'], 6) for r in report32]}")
    return launches, dict(wall_s=wall, peak_bytes=peak,
                          sequential_walls_s=seq_walls,
                          fit_ms_per_step=stats['fit_ms_per_step'],
                          rank_s=stats['rank_s'], detect_s=stats['detect_s'],
                          distances_tf32=report, distances_f32=report32,
                          top3=[top3(o) for o in odgts])


def top3(odgt):
    """A search record's three best lattices: shifts, angles, periods."""
    return [odgt[k][:3] for k in ('selected_shifts', 'selected_angles',
                                  'selected_periods')]


def _run(label, cmd, timeout=900, env=None):
    """A subprocess of this checkout's Python on the card (with `env`'s
    variables added); fails on a non-zero exit."""
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=ROOT, **(env or {})),
                          timeout=timeout)
    wall = time.time() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        fail(f'{label} exited {proc.returncode}')
    log(f'{label}: {wall:.1f} s')
    return proc, wall


def drive_entry_points():
    """The entry points a user runs, from PNG files written by the port's
    own PNG writer (utils/png.py; this machine has no OpenCV): `cli search`
    (save=True: the PNGs, the record and the grid pictures), then `cli
    complete --N_iters 11` on its output, then scripts/torch_run_suite.py
    --batched --batched-search on a directory of the three examples. The
    outputs must exist and read back."""
    import shutil
    import numpy as np
    from npp_tpu_torch.utils.io import read_rgb, write_gray, write_rgb
    from npp_tpu_torch.utils.synthetic import synthetic_search_data
    base = os.path.join(ROOT, 'npp_tpu_torch', 'build', 'smoke_files')
    shutil.rmtree(base, ignore_errors=True)

    def write_example(path, d):
        write_rgb(os.path.join(path, 'masked_img.png'), d['masked_img'])
        write_rgb(os.path.join(path, 'gt_img.png'), d['gt_img'])
        write_gray(os.path.join(path, 'unknown_mask.png'), d['unknown_mask'])
        write_gray(os.path.join(path, 'valid_mask.png'), d['valid_mask'])

    src = os.path.join(base, 'input', 'flagship')
    write_example(src, synthetic_search_data(0))
    det = os.path.join(base, 'detected')
    walls = {}
    _, walls['cli_search_s'] = _run('cli search', [
        sys.executable, '-m', 'npp_tpu_torch.cli', 'search', '--datadir',
        src, '--outdir', det])
    record = os.path.join(det, 'flagship')
    for f in ('config.odgt', 'masked_img.png', 'reg_img_0.png'):
        if not os.path.exists(os.path.join(record, f)):
            fail(f'cli search wrote no {f}')
    grid = read_rgb(os.path.join(record, 'reg_img_0.png'))
    res = os.path.join(base, 'results')
    _, walls['cli_complete_s'] = _run('cli complete', [
        sys.executable, '-m', 'npp_tpu_torch.cli', 'complete', '--datadir',
        record, '--basedir', res, '--N_iters', '11', '--i_testset', '10',
        '--i_print', '10'])
    comp = read_rgb(os.path.join(res, 'completion_top3', 'flagship',
                                 'testset_final', 'pred_rgb_img_comp.png'))
    if comp.shape != (384, 512, 3) or grid.shape != (384, 512, 3) or \
            not np.all(np.isfinite(comp)):
        fail(f'cli outputs of shapes {comp.shape}, {grid.shape}')
    suite_in = os.path.join(base, 'suite')
    for s in (0, 1, 2):
        write_example(os.path.join(suite_in, 'completion', 'input', f'ex{s}'),
                      synthetic_search_data(s))
    out = os.path.join(base, 'suite_out')
    _, walls['suite_script_s'] = _run('torch_run_suite.py', [
        sys.executable, os.path.join(ROOT, 'scripts', 'torch_run_suite.py'),
        '--input-root', suite_in, '--out', out, '--tasks', 'completion',
        '--batched', '--batched-search', '--iters-scale', '0.0055'])
    with open(os.path.join(out, 'summary.json')) as f:
        summary = json.load(f)
    recs = summary['tasks']['completion']
    if sorted(recs) != ['ex0', 'ex1', 'ex2'] or not all(
            np.isfinite(r['val_psnr']) and np.isfinite(r['val_lpips'])
            for r in recs.values()):
        fail(f'torch_run_suite.py summary {recs}')
    for name in recs:
        read_rgb(os.path.join(out, 'completion', 'results',
                              'completion_top3', name, 'testset_final',
                              'pred_rgb_img_comp.png'))
    log(f'entry points: suite records {recs}; phases {summary["phases"]}')
    quality = os.path.join(base, 'quality_out')
    _, walls['suite_quality_s'] = _run('torch_run_suite.py --preset quality', [
        sys.executable, os.path.join(ROOT, 'scripts', 'torch_run_suite.py'),
        '--input-root', suite_in, '--out', quality, '--tasks', 'completion',
        '--only', 'ex0', '--preset', 'quality', '--iters-scale', '0.0055'])
    with open(os.path.join(quality, 'summary.json')) as f:
        qsum = json.load(f)
    qrec = qsum['tasks']['completion'].get('ex0', {})
    qdir = os.path.join(quality, 'completion', 'results', 'completion_top3',
                        'ex0', 'testset_final')
    if qsum['options']['comp_seam'] != 'residual' or not all(
            np.isfinite(qrec.get(k, np.nan)) for k in
            ('val_psnr', 'val_psnr_seam', 'val_lpips', 'val_lpips_seam',
             'heldout_psnr')):
        fail(f'torch_run_suite.py --preset quality: {qsum["options"]}, '
             f'{qrec}')
    for png in ('pred_rgb_img_comp.png', 'pred_rgb_img_comp_seam.png'):
        read_rgb(os.path.join(qdir, png))
    log(f'entry points: quality preset record {qrec}')
    return dict(walls, suite=recs, suite_phases=summary['phases'],
                suite_fit=summary.get('fit_batched'),
                suite_search=summary.get('search_batched'),
                quality=qrec, quality_options=qsum['options'])


# ---- the repository's harness on the card: bench_torch.py and the
# square-wave remapping evaluation

MAIN_KERNELS = ('periodic_embed', 'bias_snake_fwd', 'bias_snake_bwd',
                'robust_rho_fwd', 'robust_rho_bwd', 'cx_chain_fwd',
                'cx_chain_bwd')
# scripts/eval_remapping.py's classical baselines on synth_blur0 (seed 300),
# deterministic numpy: its printed digits
REMAP_BASELINES = {'psnr_blur_identity': 22.3, 'psnr_blur_unsharp_1.5': 25.95,
                   'psnr_blur_unsharp_3': 27.7}


def drive_bench():
    """bench_torch.py in a subprocess without its batched and latency
    segments (phase 13 drives the batched path): its last line must hold
    bench.py's keys with 0 < mfu < 1, value > 0 and a finite vs_baseline,
    and its primary must have launched every kernel of the main path."""
    import numpy as np
    from bench_torch import METRIC_KEYS
    proc, wall = _run('bench_torch.py', [
        sys.executable, os.path.join(ROOT, 'bench_torch.py')],
        env={'NPP_BENCH_BATCHED': '0', 'NPP_BENCH_LATENCY': '0'})
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    diag = json.loads([ln for ln in proc.stderr.splitlines()
                       if ln.startswith('{')][-1])
    log(f'bench_torch.py: {json.dumps(line)}')
    launches = diag['primary']['launches']
    if set(line) != set(METRIC_KEYS) or line['metric'] != \
            'completion_fit_iters_per_sec' or not line['value'] > 0 or \
            not 0 < line['mfu'] < 1 or \
            not np.isfinite(line['vs_baseline'] or np.nan):
        fail(f'bench_torch.py line {line}')
    missing = [k for k in MAIN_KERNELS if not launches.get(k)]
    if missing:
        fail(f'bench_torch.py primary launched no {missing}: {launches}')
    log(f"bench_torch.py: block ms {diag['primary']['block_ms']}, control "
        f"{diag['control']['iters_per_sec']:.3f} it/s, peak "
        f"{diag['primary']['peak_memory_bytes']} bytes")
    return dict(line=line, wall_s=wall, block_ms=diag['primary']['block_ms'],
                launches=launches, control=diag['control'],
                flops_per_step=diag['flops_per_step'])


def drive_remap_eval():
    """scripts/torch_eval_remapping.py --n-synth 1 --iters-scale 0.05: the
    record holds eval_remapping.py's keys with finite PSNRs and LPIPS, its
    baselines equal that script's record, and the summary line follows."""
    import shutil
    import numpy as np
    out = os.path.join(ROOT, 'npp_tpu_torch', 'build', 'smoke_remap_eval')
    shutil.rmtree(out, ignore_errors=True)
    proc, wall = _run('torch_eval_remapping.py', [
        sys.executable, os.path.join(ROOT, 'scripts',
                                     'torch_eval_remapping.py'),
        '--n-synth', '1', '--iters-scale', '0.05', '--out', out])
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith('{')]
    rec, summary = lines[-2], lines[-1]
    keys = {'example', 'blur_frac'} | {
        f'{m}_blur_{b}' for m in ('psnr', 'lpips')
        for b in ('identity', 'unsharp_1.5', 'unsharp_3')} | {
        f'{k}_ref' for k in ('psnr_blur_ours', 'lpips_blur_ours',
                             'psnr_clear_ours', 'iters_per_sec')}
    finite = all(np.isfinite(v) for k, v in rec.items() if k != 'example')
    if set(rec) != keys or not finite or set(summary.get('summary', ())) != \
            {'beats_best_baseline_psnr', 'beats_best_baseline_lpips', 'total'}:
        fail(f'torch_eval_remapping.py lines {lines[-2:]}')
    if any(rec[k] != v for k, v in REMAP_BASELINES.items()):
        fail(f'torch_eval_remapping.py baselines {rec} against '
             f'eval_remapping.py\'s {REMAP_BASELINES}')
    runs = json.loads([ln for ln in proc.stderr.splitlines()
                       if ln.startswith('{')][-1])
    log(f'torch_eval_remapping.py: {json.dumps(rec)}; searches '
        f'{runs["searches"]}; fits {runs["fits"]}')
    return dict(record=rec, summary=summary['summary'], wall_s=wall,
                searches=runs['searches'], fits=runs['fits'])


# ---- the seam slice: the inpainting library, LPIPS-squeeze's K4 shapes,
# the weight sources, the seam-aware composite and the quality preset

INPAINT_GOLDEN = os.path.join(ROOT, 'tests', 'fixtures',
                              'torch_inpaint_ns_cv2.npz')
# LPIPS-squeeze's seven layers at the completion's robust batch (six
# 160x160 patches): relu1 79x79 x 64 after the stride-2 conv, then the
# ceil-mode pools' 39x39 x 128, 19x19 x 256 and 9x9 x 384, 384, 512, 512
SQ_K4 = [(6 * s * s, c) for s, c in ((79, 64), (39, 128), (19, 256),
                                     (9, 384), (9, 384), (9, 512), (9, 512))]
SQ_STEPS = 10


def check_inpaint():
    """The Navier-Stokes inpainting library (csrc/inpaint_ns.cpp, built on
    this machine) against cv2's own outputs, made where cv2 is installed
    (scripts/make_torch_inpaint_golden.py): every pixel equal."""
    import numpy as np
    from npp_tpu_torch.ops.inpaint import inpaint_ns
    out = {}
    with np.load(INPAINT_GOLDEN) as g:
        for case in sorted({k.split('_')[0] for k in g.files}):
            t0 = time.perf_counter()
            got = inpaint_ns(g[f'{case}_src'], g[f'{case}_mask'],
                             float(g[f'{case}_radius']))
            ms = 1e3 * (time.perf_counter() - t0)
            bad = int(np.count_nonzero(got != g[f'{case}_out']))
            log(f'inpaint {case} {g[f"{case}_src"].shape}: {bad} values '
                f'differ from cv2\'s; {ms:.2f} ms on the host')
            if bad:
                fail(f'inpaint: {case} differs from the cv2 golden in {bad} '
                     'values')
            out[case] = dict(shape=list(g[f'{case}_src'].shape), ms=ms)
    return out


def squeeze_names():
    """The kernel entries of the squeeze path (named like its launch
    counts)."""
    shapes = ','.join(f'{m}x{c}' for m, c in SQ_K4)
    return [f'robust_rho_fwd_group[{shapes}]'] + \
        [f'robust_rho_bwd[{m}x{c}]' for m, c in dict.fromkeys(SQ_K4)]


def check_k4_squeeze(gen):
    """K4 at LPIPS-squeeze's seven layers: the forward as one grouped
    launch (judge_k4_fwd at every alpha; each layer also timed alone),
    the backward at each distinct shape."""
    from npp_tpu_torch.kernels import robust_rho as rr
    err = judge_k4_fwd(gen, SQ_K4)
    segs = [k4_inputs(gen, m, c, 'spread') for m, c in SQ_K4]
    singles = []
    for (m, c), seg in zip(SQ_K4, segs):
        b_ms, _ = bound_ms(*fwd_bytes_ops(m, c))
        singles.append(dict(
            shape=[m, c], **device_times(lambda: rr.rho_fwd_launch(*seg)),
            eager_ms=eager_ms(lambda: rr.rho_fwd_launch(*seg)),
            bound_ms=b_ms))
    n_bytes, ops = (sum(v) for v in zip(*[fwd_bytes_ops(m, c)
                                          for m, c in SQ_K4]))
    out = [k4_entry(squeeze_names()[0], FWD_SRC, [list(sh) for sh in SQ_K4],
                    err, lambda: rr.rho_fwd_group_launch(segs),
                    lambda: rr.rho_rows_group_plain(*zip(*segs)), n_bytes,
                    ops, segments=singles)]
    for m, c in dict.fromkeys(SQ_K4):
        out.append(k4_bwd_entry(gen, m, c, ('spread',)))
    return out


def squeeze_batch(seed):
    """Six 160x160 patches and a perturbed copy (NHWC in [0, 1]), and
    latents moved off their zero init, from a seed."""
    import torch
    g = torch.Generator().manual_seed(seed)
    a = torch.rand(6, 160, 160, 3, generator=g)
    b = torch.clamp(a + 0.2 * torch.randn(a.shape, generator=g), 0, 1)
    lat = [(torch.randn(1, c, generator=g), torch.randn(1, c, generator=g) - 1)
           for c in (64, 128, 256, 384, 384, 512, 512)]
    return a, b, lat


def check_lpips_squeeze():
    """LPIPS-squeeze robust on the card (K4 both ways) against the CPU
    (plain versions), full f32 on both, with check_step's bars: the value
    within 1e-4 relative, every gradient (input, latent_alpha,
    latent_scale) within 1e-2 of the CPU's largest magnitude. Both are
    also measured against a float64 evaluation on the CPU."""
    import copy
    import torch
    from npp_tpu_torch.losses.lpips import LPIPS
    a, b, lat = squeeze_batch(0)
    res = {}
    for dev, dt in (('cuda', torch.float32), ('cpu', torch.float32),
                    ('cpu', torch.float64)):
        lp = LPIPS(torch.device(dev), net='squeeze')
        if dt == torch.float64:    # a float64 copy; the cached tower stays
            lp = copy.copy(lp)
            lp.tower = copy.copy(lp.tower)
            lp.tower.params = {k: (w.double(), bb.double())
                               for k, (w, bb) in lp.tower.params.items()}
            lp.tower.dtype = dt
            lp.lins = [t.double() for t in lp.lins]
            lp.shift, lp.scale = lp.shift.double(), lp.scale.double()
        lats = lp.init_adaptive().to(dev)
        with torch.no_grad():
            for p, (la, ls) in zip(lats, lat):
                p.latent_alpha.copy_(la)
                p.latent_scale.copy_(ls)
        lats = lats.to(dt)
        x = a.to(dev, dt, copy=True).requires_grad_()
        v = torch.mean(lp(x, b.to(dev, dt), use_robust=True, adaptive=lats,
                          normalize=True))
        v.backward()
        res[dev, dt] = (v.detach().double().cpu(), x.grad.double().cpu(),
                        [p.latent_alpha.grad.double().cpu() for p in lats],
                        [p.latent_scale.grad.double().cpu() for p in lats])

    def errs(got, ref):
        def rel(g, r):
            return float((g - r).abs().max() / r.abs().max())
        return dict(value=rel(got[0], ref[0]), input=rel(got[1], ref[1]),
                    latent_alpha=max(map(rel, got[2], ref[2])),
                    latent_scale=max(map(rel, got[3], ref[3])))

    card, cpu, f64 = (res[k] for k in (('cuda', torch.float32),
                                       ('cpu', torch.float32),
                                       ('cpu', torch.float64)))
    out = dict(card_vs_cpu=errs(card, cpu), card_vs_f64=errs(card, f64),
               cpu_vs_f64=errs(cpu, f64))
    log(f'LPIPS-squeeze robust, f32: value {float(card[0]):.6f} on the card, '
        f'{float(cpu[0]):.6f} on the CPU; relative errors {out}')
    bad = {k: v for k, v in out['card_vs_cpu'].items()
           if not v <= (1e-4 if k == 'value' else 1e-2)}
    if bad:
        fail(f'LPIPS-squeeze card vs CPU: {bad}')
    return out


def drive_squeeze():
    """The squeeze path: SQ_STEPS Adam steps on six 160x160 patches and
    the seven layers' latents under LPIPS-squeeze robust (the public LPIPS
    API, net='squeeze', TF32 off), every launch count set to 0 just before
    and read just after: one grouped K4 forward a step and one backward a
    layer. The loss must stay finite and fall."""
    import torch
    from npp_tpu_torch.kernels import launch_counts, reset_launches
    from npp_tpu_torch.losses.lpips import LPIPS
    dev = torch.device('cuda')
    a, b, _ = squeeze_batch(1)
    lp = LPIPS(dev, net='squeeze')
    lats = lp.init_adaptive().to(dev)
    x = a.to(dev).requires_grad_()
    b = b.to(dev)
    opt = torch.optim.Adam([x, *lats.parameters()], lr=1e-2)
    reset_launches()
    t0 = time.time()
    losses = []
    for _ in range(SQ_STEPS):
        opt.zero_grad()
        loss = torch.mean(lp(x, b, use_robust=True, adaptive=lats,
                             normalize=True))
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts()
    log(f'squeeze path: loss {losses[0]:.5f} -> {losses[-1]:.5f} in '
        f'{SQ_STEPS} steps, {1e3 * wall / SQ_STEPS:.2f} ms/step; launches '
        f'{launches}')
    names = squeeze_names()
    want = {names[0]: SQ_STEPS}
    for m, c in SQ_K4:
        key = f'robust_rho_bwd[{m}x{c}]'
        want[key] = want.get(key, 0) + SQ_STEPS
    wrong = {k: launches.get(k, 0) for k, v in want.items()
             if launches.get(k, 0) != v}
    if wrong or not all(map(lambda v: v == v and abs(v) < 1e30, losses)) \
            or not losses[-1] < losses[0]:
        fail(f'squeeze path: launches {wrong} (expected {want}), losses '
             f'{losses}')
    return launches, dict(losses=losses, ms_per_step=1e3 * wall / SQ_STEPS)


def check_weight_sources():
    """The converted weight sources on the card: a torchvision-keyed
    AlexNet state_dict (random, from a seed) written with torch.save is
    found through NPP_TPU_TORCH_WEIGHTS (report 'torch'); the same weights
    as an HWIO npz through NPP_TPU_WEIGHTS_DIR (report 'weights_dir', which
    wins over the .pth, as in npp_tpu) give the same LPIPS-alex value."""
    import numpy as np
    import torch
    from npp_tpu_torch.losses.lpips import LPIPS
    from npp_tpu_torch.nn.features import ALEX_CONV_SHAPES
    from npp_tpu_torch.nn.pretrained import weight_reports
    d = os.path.join(ROOT, 'npp_tpu_torch', 'build', 'smoke_weights')
    os.makedirs(d, exist_ok=True)
    g = torch.Generator().manual_seed(0)
    state, flat = {}, {}
    for n, (i, (kh, kw, cin, cout)) in enumerate(zip(
            (0, 3, 6, 8, 10), ALEX_CONV_SHAPES.values())):
        w = torch.randn(cout, cin, kh, kw, generator=g) / (kh * kw * cin) ** .5
        bias = 0.1 * torch.randn(cout, generator=g)
        state[f'features.{i}.weight'], state[f'features.{i}.bias'] = w, bias
        flat[f'conv{n}/kernel'] = w.numpy().transpose(2, 3, 1, 0)
        flat[f'conv{n}/bias'] = bias.numpy()
    torch.save(state, os.path.join(d, 'alexnet_tv.pth'))
    np.savez(os.path.join(d, 'alexnet_tv.npz'), **flat)
    a, b, _ = squeeze_batch(2)
    dev = torch.device('cuda')
    out = {}
    saved = {k: os.environ.pop(k, None) for k in ('NPP_TPU_TORCH_WEIGHTS',
                                                  'NPP_TPU_WEIGHTS_DIR')}
    try:
        for env in ({'NPP_TPU_TORCH_WEIGHTS': d},
                    {'NPP_TPU_TORCH_WEIGHTS': d, 'NPP_TPU_WEIGHTS_DIR': d}):
            os.environ.update(env)
            with torch.no_grad():
                v = float(torch.mean(LPIPS(dev, net='alex')(
                    a.to(dev), b.to(dev), normalize=True)))
            src = weight_reports()['alexnet_tv'].source
            out[src] = v
            log(f'weights {sorted(env)}: alexnet_tv from {src!r}, LPIPS-alex '
                f'{v:.7f}')
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    if sorted(out) != ['torch', 'weights_dir'] or \
            abs(out['torch'] - out['weights_dir']) > 1e-6 * abs(out['torch']):
        fail(f'weight sources: {out}')
    return out


def drive_seam():
    """The completion with comp_seam='residual', 11 iterations: the
    composite is the seam-corrected one, made by the port's inpainting
    library on the host at every eval; its host time per call is taken
    around the library."""
    import numpy as np
    import npp_tpu_torch.models.completion as completion
    calls = []
    inpaint = completion.inpaint_ns

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = inpaint(*args, **kw)
        calls.append(1e3 * (time.perf_counter() - t0))
        return out

    completion.inpaint_ns = timed
    try:
        launches, history, _, final = drive(
            'seam path', ['periodic_embed', 'bias_snake_fwd',
                          'bias_snake_bwd', 'robust_rho_fwd',
                          'robust_rho_bwd', *sorted(k3_names(K3_FIT))],
            N_iters=11, comp_seam='residual')
    finally:
        completion.inpaint_ns = inpaint
    if not np.array_equal(final['pred_rgb_img_comp'],
                          final['pred_rgb_img_comp_seam']) or not calls:
        fail('seam path: the composite is not the seam composite')
    log(f"seam path: val_psnr {final['val_psnr']:.3f} vs val_psnr_seam "
        f"{final['val_psnr_seam']:.3f}; val_lpips_seam "
        f"{final['val_lpips_seam']:.5f}; inpainting {len(calls)} calls, "
        f"{np.median(calls):.2f} ms each (median) on the host")
    return launches, dict(
        ms_per_step=[h['ms_per_step'] for h in history],
        val_psnr=final['val_psnr'], val_psnr_seam=final['val_psnr_seam'],
        val_lpips=final['val_lpips'], val_lpips_seam=final['val_lpips_seam'],
        inpaint_host_ms=calls)




# ---- K3, the CX similarity chain (csrc/cx_chain.cu): its shapes on the
# paths, (N, P = Q, C) at VGG19 relu3_4, where a patch of s pixels gives
# (s // 4)^2 positions: the completion's six 160^2 patches (2 fake x K=3
# real), the batched fit's three images of six, the remapping's and the
# segmentation's six 64^2 patches, and the search's eval, three candidates
# a call at the 384x512 crop (forward only, f32, masked in cx_bbox when
# cx_mask_pad is on)
K3_FIT = (6, 1600, 256)
K3_BATCHED = (18, 1600, 256)
K3_PATCH64 = (6, 256, 256)
K3_SEARCH = (3, 12288, 256)
K3_SRC = 'npp_tpu_torch/csrc/cx_chain.cu'
K3_REPLACES = ('npp_tpu/losses/contextual.py:21-130 (cosine distance, '
               'relative distance, exp / row normalisation, masked column '
               'max{}; XLA-fused, no pl.pallas_call in the repo)')
K3_F64_BAR = 1e-4       # K3's z against float64, relative to its largest
K3_GRAD_BAR = 1e-3      # K3's gradients, relative to the largest
K3_TF32_BAR = 2e-3      # K3 against the plain chain, both with TF32 (each
                        # about 1.5e-3 from float64, rounding apart)


def k3_name(kind, n, p, c):
    return f'cx_chain_{kind}[{n}x{p}x{p}x{c}]'


def k3_names(shape, kinds=('fwd', 'bwd')):
    return {k3_name(kind, *shape) for kind in kinds}


def k3_rows(gen, n, p, c, dup=0):
    """Normalised rows as the fits make them, on the card: relu features
    y, x near y, shifted by y's mean (losses/contextual.py::
    normalized_features). dup: the `dup` positions from p // 2 repeat the
    first `dup` exactly, in x and in y (equal rows and columns: tied
    maxima and minima, as the fits' cx_pred * real_mask makes them)."""
    import torch
    from npp_tpu_torch.losses.contextual import normalized_features
    y = torch.relu(torch.randn(n, p, 1, c, generator=gen))
    x = y + 0.5 * torch.randn(n, p, 1, c, generator=gen)
    for t in (x, y):
        t[:, p // 2:p // 2 + dup] = t[:, :dup]
    return normalized_features(x.cuda(), y.cuda())


def k3_bound_ms(n, p, c, kind, tf32, masked=False):
    """The forward reads xn and yn (and the mask) and writes z: one product
    of 2 N P^2 C operations; the backward reads xn, yn and g and writes
    dxn and dyn: two products. Against the TF32 or the f32 peak."""
    if kind == 'fwd':
        n_bytes = (2 * n * p * c + n * p * (2 if masked else 1)) * 4
        ops = 2 * n * p * p * c
    else:
        n_bytes, ops = (4 * n * p * c + n * p) * 4, 4 * n * p * p * c
    t_bytes = n_bytes / PEAKS.hbm_bytes_per_s
    t_ops = ops / (PEAKS.tf32 if tf32 else PEAKS.f32)
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def k3_run(fn, xn, yn, fv, g, dtype):
    """z and, with g, its gradients in xn and yn, of fn (the kernel or the
    plain chain) in dtype."""
    import torch
    a = xn.to(dtype).detach().requires_grad_(g is not None)
    b = yn.to(dtype).detach().requires_grad_(g is not None)
    z = fn(a, b, 0.5, None if fv is None else fv.to(dtype))
    out = (z.detach(),)
    if g is not None:
        out += torch.autograd.grad(z, (a, b), g.to(dtype))
    torch.cuda.synchronize()
    return out


def k3_rel(got, want):
    return float((got.double() - want.double()).abs().max() /
                 want.double().abs().max().clamp_min(1e-30))


def k3_tie_errs(gen, n, p, c):
    """K3's z and gradients against the plain version's on inputs where a
    fifth of the positions repeat others exactly (exact ties in the max
    and the min), then with a mask that leaves sample 1 all masked, in f32
    and with TF32: {'f32': x, 'tf32': x}, each the largest difference
    relative to the plain version's largest value. (Zeroed feature rows
    would put s at the clamp's edge 1, where any two f32 products may fall
    on either side and the gradient jumps.)"""
    from npp_tpu_torch.device import matmul_precision
    from npp_tpu_torch.kernels import cx_chain as K
    import torch
    xn, yn = k3_rows(gen, n, p, c, dup=p // 5)
    fv = (torch.rand(n, p, generator=gen) > 0.3).float().cuda()
    fv[1] = 0.0
    g = (torch.rand(n, p, generator=gen) + 0.5).cuda()
    worst = {}
    for tag, prec in (('f32', 'float32'), ('tf32', 'bfloat16')):
        with matmul_precision(prec):
            for mask in (None, fv):
                got = k3_run(K.cx_colmax, xn, yn, mask, g, torch.float32)
                want = k3_run(K.cx_colmax_plain, xn, yn, mask, g,
                              torch.float32)
                worst[tag] = max([worst.get(tag, 0.0)] +
                                 [k3_rel(a, b) for a, b in zip(got, want)])
    return worst


def k3_pass_ms(fn, iters=5):
    """Device ms per call of each kernel that fn launches, by name
    (torch.profiler; K3's names as csrc/cx_chain.cu gives them, e.g.
    'cx_gemm_tf32', 'cx_row_stats<0>')."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, 'self_device_time_total', None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r'cx_\w+(<\d+>)?', ev.key)
            name = m.group(0) if m else ev.key[:60]
            out[name] = out.get(name, 0.0) + us / 1e3 / iters
    return out


def k3_wgmma_count():
    """The wgmma.mma_async instructions of csrc/cx_chain.cu's PTX (nvcc
    -ptx for sm_90a, written under the build directory)."""
    from npp_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR, nvcc_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, 'cx_chain.ptx')
    subprocess.run([nvcc_path(), '-arch=sm_90a', '-std=c++17', '-O3', '-ptx',
                    '-o', out, os.path.join(CSRC_DIR, 'cx_chain.cu')],
                   check=True, capture_output=True)
    with open(out) as f:
        return sum(line.count('wgmma.mma_async') for line in f)


def k3_form_errs(gen, mode, n, p, c):
    """K3's l2 or l1 form against its plain chain at (N, P, C): raw relu
    features (x near y; l1 their channel sums), with the all-masked
    sample of k3_tie_errs' mask. z and both gradients of the kernel and
    of the plain chain against float64 in f32 (K3_F64_BAR, K3_GRAD_BAR,
    and no worse than twice the plain chain's distance), and the kernel
    against the plain chain with TF32 on (the TF32 bar where the plain
    chain itself stays within it of float64: l2's distances subtract
    products of raw rows, which TF32 rounds far more coarsely). Device
    ms (cold; the forward also warm and eager) of both directions, kernel
    and plain, in f32, and the forward's bound (l2: its product, as K3's;
    l1: its bytes, as it has no product)."""
    import torch
    from npp_tpu_torch.device import matmul_precision
    from npp_tpu_torch.kernels import cx_chain as K
    y = torch.relu(torch.randn(n, p, c, generator=gen))
    x = y + 0.5 * torch.randn(n, p, c, generator=gen)
    if mode == 'l1':
        x, y = x.sum(-1), y.sum(-1)
    x, y = x.cuda(), y.cuda()
    fv = (torch.rand(n, p, generator=gen) > 0.3).float().cuda()
    fv[1] = 0.0
    g = (torch.rand(n, p, generator=gen) + 0.5).cuda()
    kern = K.cx_colmax_l2 if mode == 'l2' else K.cx_colmax_l1
    plain = K.PLAIN[mode]
    out = dict(shape=[n, p, p, c], passed=True)
    for mask in (None, fv):
        tag = 'masked' if mask is not None else 'plain'
        with matmul_precision('float32'):
            runs = [k3_run(fn, x, y, mask, g, dt) for fn, dt in (
                (kern, torch.float32), (plain, torch.float32),
                (plain, torch.float64))]
        k64 = [k3_rel(a, b) for a, b in zip(runs[0], runs[2])]
        p64 = [k3_rel(a, b) for a, b in zip(runs[1], runs[2])]
        bars = (K3_F64_BAR, K3_GRAD_BAR, K3_GRAD_BAR)
        ok = all(e <= max(b, 2 * pe) for e, b, pe in zip(k64, bars, p64))
        with matmul_precision('bfloat16'):
            tf = [k3_run(fn, x, y, mask, g, torch.float32)
                  for fn in (kern, plain)]
        tf_diff = [k3_rel(a, b) for a, b in zip(*tf)]
        tf_p64 = [k3_rel(a, b) for a, b in zip(tf[1], runs[2])]
        if max(tf_p64) <= K3_TF32_BAR:
            ok &= max(tf_diff) <= K3_TF32_BAR
        out[tag] = dict(
            rel_err_vs_f64=k64, plain_rel_err_vs_f64=p64,
            tf32_err_vs_plain=tf_diff, tf32_plain_rel_err_vs_f64=tf_p64,
            max_abs_err=float((runs[0][0] - runs[1][0]).abs().max()))
        out['passed'] &= ok
        del runs, tf
    with matmul_precision('float32'):
        kf = lambda: kern(x, y, 0.5, fv)  # noqa: E731
        pf = lambda: plain(x, y, 0.5, fv)  # noqa: E731

        def both(fn):
            def run():
                a, b = (t.detach().requires_grad_() for t in (x, y))
                return torch.autograd.grad(fn(a, b, 0.5, fv), (a, b), g)
            return run
        out.update(**device_times(kf, iters=10),
                   eager_ms=eager_ms(kf, iters=10),
                   plain_ms=time_ms(pf, iters=10),
                   fwd_bwd_ms=time_ms(both(kern), iters=10),
                   plain_fwd_bwd_ms=time_ms(both(plain), iters=10))
    if mode == 'l2':
        out['bound_ms'], out['bound_by'] = k3_bound_ms(n, p, c, 'fwd', False,
                                                       masked=True)
    else:   # no product: the two channel sums and the mask in, z out
        out['bound_ms'], out['bound_by'] = (1e3 * 16 * n * p /
                                            PEAKS.hbm_bytes_per_s), 'bytes'
    return out


def k3_peak_mib(fn):
    """MiB that one call of fn allocates at its peak above what was
    allocated before it."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def check_k3(gen, shape, backward, masked=False, iters=20):
    """K3 at one shape (N, P, C): z judged against the plain chain in f32
    and in float64 (judge(), and K3_F64_BAR against float64); with
    `backward` (a fit's shape), its gradients in xn and yn within
    K3_GRAD_BAR of the largest float64 value, on the tie and all-masked
    inputs of k3_tie_errs within K3_GRAD_BAR of the plain version's, and
    with TF32, as the fits run it, z and the gradients (the tie and
    all-masked inputs too) within K3_TF32_BAR of the plain chain's, also
    with TF32. Timed (device cold and warm, eager, the plain chain) as its
    path runs it: a fit's shape with TF32 (and in f32 beside it), the
    search's in f32; the backward with both gradients, as its bound
    counts, and with dxn alone as the fits run it, against the plain
    chain's backward alone (its forward and backward less its forward).
    The design's own figures: each pass's device ms (k3_pass_ms, warm),
    the scratch bytes of kernels/cx_chain.py::Plan and the peak memory of
    each direction, the kernel's and (forward) the plain chain's. Entries
    named like the launch counts."""
    import torch
    from npp_tpu_torch.device import matmul_precision
    from npp_tpu_torch.kernels import cx_chain as K
    n, p, c = shape
    xn, yn = k3_rows(gen, n, p, c)
    fv = (torch.rand(n, p, generator=gen) > 0.2).float().cuda() \
        if masked else None
    g = (torch.rand(n, p, generator=gen) + 0.5).cuda() if backward else None
    runs = [k3_run(fn, xn, yn, fv, g, dt) for fn, dt in (
        (K.cx_colmax, torch.float32), (K.cx_colmax_plain, torch.float32),
        (K.cx_colmax_plain, torch.float64))]
    err = {'fwd': judge([(runs[0][0], runs[1][0], runs[2][0])])}
    err['fwd']['passed'] &= err['fwd']['rel_err_vs_f64'] <= K3_F64_BAR
    if backward:
        e = judge(list(zip(*runs))[1:], floor=K3_GRAD_BAR)
        ties = k3_tie_errs(gen, n, p, c)
        e['tie_mask_err_vs_plain'] = ties['f32']
        e['passed'] = e['rel_err_vs_f64'] <= K3_GRAD_BAR and \
            ties['f32'] <= K3_GRAD_BAR
        err['bwd'] = e
        with matmul_precision('bfloat16'):
            tf = [k3_run(fn, xn, yn, fv, g, torch.float32)
                  for fn in (K.cx_colmax, K.cx_colmax_plain)]
        # z, dxn, dyn: the kernel against the plain chain, and each against
        # float64, all with TF32
        diff = [k3_rel(a, b) for a, b in zip(*tf)]
        k64, p64 = ([k3_rel(a, b) for a, b in zip(t, runs[2])] for t in tf)
        for kind, at in (('fwd', slice(0, 1)), ('bwd', slice(1, 3))):
            err[kind].update(tf32_err_vs_plain=max(diff[at]),
                             tf32_rel_err_vs_f64=max(k64[at]),
                             tf32_plain_rel_err_vs_f64=max(p64[at]))
            err[kind]['passed'] &= max(diff[at]) <= K3_TF32_BAR
        err['bwd']['tf32_tie_mask_err_vs_plain'] = ties['tf32']
        err['bwd']['passed'] &= ties['tf32'] <= K3_TF32_BAR
        del tf
    del runs
    tf32 = backward   # a fit's shape runs with TF32, the search's eval in f32

    def fns(kind, prec):
        """(kernel, plain) callables of one direction at one precision;
        the backward's kernel takes need_dy=False for dxn alone, and its
        plain callable is the plain chain's forward and backward (its
        backward's nodes run on the forward's stream, so a backward alone
        cannot be captured in a graph apart from its forward)."""
        if kind == 'fwd':
            return (lambda: K.cx_colmax(xn, yn, 0.5, fv),
                    lambda: K.cx_colmax_plain(xn, yn, 0.5, fv))
        z, saved = K.cx_fwd_launch(xn, yn, fv, 0.5, prec)

        def plain():
            a, b = (t.detach().requires_grad_() for t in (xn, yn))
            return torch.autograd.grad(K.cx_colmax_plain(a, b, 0.5, fv),
                                       (a, b), g)
        return (lambda **kw: K.cx_bwd_launch(g, xn, yn, fv, saved, z, 0.5,
                                             prec, **kw), plain)

    def plain_ms(kind, prec):
        """The plain chain's device ms in one direction, and for the
        backward its forward and backward; the backward alone is the two
        less the forward."""
        fwd = time_ms(fns('fwd', prec)[1], iters=iters)
        if kind == 'fwd':
            return fwd, fwd
        both = time_ms(fns('bwd', prec)[1], iters=iters)
        return both - fwd, both

    out = []
    for kind in ('fwd', 'bwd') if backward else ('fwd',):
        extra = {}
        with matmul_precision('bfloat16' if tf32 else 'float32'):
            prec = K.PREC_TF32 if tf32 else K.PREC_F32
            kernel, plain = fns(kind, prec)
            times = device_times(kernel, iters=iters)
            e_ms = eager_ms(kernel, iters=iters)
            p_ms, p_both = plain_ms(kind, prec)
            if kind == 'bwd':
                extra.update(plain_fwd_bwd_ms=p_both, dx_only_ms=time_ms(
                    lambda: kernel(need_dy=False), iters=iters))
            pl = K.plan(n, p, p, c)
            extra.update(
                passes_ms=k3_pass_ms(kernel),
                scratch_bytes=K.buffer_bytes(
                    pl.forward_buffers('cosine', prec) if kind == 'fwd' else
                    pl.backward_buffers('cosine', True, True)),
                product_tiles=pl.product_tiles(p, p if kind == 'fwd' else c),
                peak_mib=k3_peak_mib(kernel))
            if kind == 'fwd':
                extra['plain_peak_mib'] = k3_peak_mib(plain)
            del kernel, plain
        if tf32:
            with matmul_precision('float32'):
                kernel, _ = fns(kind, K.PREC_F32)
                extra.update(ms_f32=time_ms(kernel, iters=iters),
                             plain_ms_f32=plain_ms(kind, K.PREC_F32)[0],
                             bound_ms_f32=k3_bound_ms(n, p, c, kind, False,
                                                      masked)[0])
                del kernel
        b_ms, b_by = k3_bound_ms(n, p, c, kind, tf32, masked)
        out.append(dict(
            name=k3_name(kind, n, p, c), route='cuda', source=K3_SRC,
            replaces=K3_REPLACES.format(', its gradient' if kind == 'bwd'
                                        else ''),
            shape=[n, p, p, c], masked=masked,
            precision='tf32' if tf32 else 'f32', **err[kind], **times,
            eager_ms=e_ms, plain_ms=p_ms, bound_ms=b_ms, bound_us=1e3 * b_ms,
            bound_by=b_by, library_ms=None, **extra))
    return out


def check_k3_all(gen):
    """K3 at the completion's, the batched fit's, the 64^2 patches' (the
    remapping and the segmentation) and the search eval's shapes; the
    search's with its mask, forward only. Ten timed calls a replay (three
    at the search's shape) keep the phase's time down."""
    return check_k3(gen, K3_FIT, True, iters=10) + \
        check_k3(gen, K3_BATCHED, True, iters=10) + \
        check_k3(gen, K3_PATCH64, True, iters=10) + \
        check_k3(gen, K3_SEARCH, False, masked=True, iters=3)


def check_k3_forms(gen):
    """K3's l2 and l1 forms (no entry point runs them) at the 64^2
    patches' 6 x 256 and the completion's 6 x 1,600 (k3_form_errs)."""
    out = []
    for mode in ('l2', 'l1'):
        for n, p, c in (K3_PATCH64, K3_FIT):
            e = k3_form_errs(gen, mode, n, p, c)
            e['name'] = f'cx_chain_{mode}[{n}x{p}x{p}x{c}]'
            out.append(e)
            log(f"K3 {mode} form at {n}x{p}x{c}: passed {e['passed']}; "
                + '; '.join(f"{t} vs f64 {e[t]['rel_err_vs_f64']} (plain "
                            f"{e[t]['plain_rel_err_vs_f64']}), TF32 vs plain "
                            f"{e[t]['tf32_err_vs_plain']}"
                            for t in ('plain', 'masked'))
                + f"; fwd {e['ms']:.4f} ms (warm {e['warm_ms']:.4f}, eager "
                f"{e['eager_ms']:.4f}, bound {e['bound_ms']:.4f}; plain "
                f"{e['plain_ms']:.4f}), "
                f"fwd+bwd {e['fwd_bwd_ms']:.4f} (plain "
                f"{e['plain_fwd_bwd_ms']:.4f})")
    return out


# ---- the multi-card slice: the mesh over torch.distributed ranks

MC_PATHS = ('nccl', 'gloo_two_ranks_one_card')
K_BASE = ('periodic_embed_batched', 'bias_snake_fwd', 'bias_snake_bwd',
          'robust_rho_fwd', 'robust_rho_bwd', 'cx_chain_fwd', 'cx_chain_bwd')
MC_DEADLINE = 400.0


def _multicard_rank(flagship=None):
    """One rank of the multi-card phase, in a process of
    npp_tpu_torch/parallel/launch.py::spawn (its group joined, its card
    current): fit_images on the flagship seeds 0-2 with the images over
    the group's ranks (default CompletionConfig, 21 iterations), every
    launch count set to 0 just before and read just after; image 0
    rendered pixel-sharded and by make_render. With `flagship` (the
    search's detection of seed 0) also rank_proposals of its candidates
    unsharded and over a 'candidates' axis in full f32, and
    run_search_suite of phase 14's three images over an 'images' axis,
    each counted the same way."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from npp_tpu_torch.config import CompletionConfig, SearchConfig, replace
    from npp_tpu_torch.device import resolve_device
    from npp_tpu_torch.kernels import launch_counts, reset_launches
    from npp_tpu_torch.models.trainer import COMPLETION_TASK
    from npp_tpu_torch.parallel.batch import make_sharded_render
    from npp_tpu_torch.parallel.mesh import make_mesh
    from npp_tpu_torch.parallel.runner import fit_images
    from npp_tpu_torch.utils.synthetic import synthetic_data
    group = dist.group.WORLD
    rank = dist.get_rank()
    dev = resolve_device(None)
    own = torch.device('cuda', rank % torch.cuda.device_count())
    if dev != own:
        raise RuntimeError(f'rank {rank} resolved {dev}, its card is {own}')
    out = {'rank': rank, 'device': str(dev), 'backend': dist.get_backend()}

    def counted(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        rec = {'wall_s': time.time() - t0,
               'peak_bytes': torch.cuda.max_memory_allocated(),
               'launches': {k: v for k, v in launch_counts().items() if v}}
        return res, rec

    cfg = replace(CompletionConfig(), N_iters=21, i_testset=10, i_print=10)
    datas = [synthetic_data(s) for s in (0, 1, 2)]
    stats = {}
    (states, ctxs), out['fit'] = counted(lambda: fit_images(
        cfg, COMPLETION_TASK, datas, return_ctx=True, stats=stats,
        mesh=make_mesh(('images',), group=group)))
    mine = stats['buckets'][0]['ranks'][rank]
    out['fit'].update(images=mine['images'],
                      ms_per_step_steady=mine['ms_per_step_steady'])
    out['params'] = host_params(states)
    render = make_sharded_render(cfg, ctxs[0]['embedder'],
                                 make_mesh(('pixels',), group=group))
    got = render(states[0].params, 384, 512)
    want = ctxs[0]['render'](states[0].params, 384, 512)
    out['render'] = {'bit_equal': bool(torch.equal(got, want)),
                     'max_abs_diff': float((got - want).abs().max()),
                     'finite': bool(torch.isfinite(got).all()),
                     'shape': tuple(got.shape)}
    if flagship is None:
        return out
    from npp_tpu_torch.losses.contextual import ContextualLoss
    from npp_tpu_torch.losses.lpips import LPIPS
    from npp_tpu_torch.proposal.ranking import rank_proposals
    from npp_tpu_torch.proposal.search import run_search_suite
    from npp_tpu_torch.utils.synthetic import synthetic_search_data
    percep, cx = LPIPS(dev, net='vgg'), ContextualLoss(dev)
    scfg = replace(SearchConfig(), matmul_precision='float32')
    args = (scfg, flagship['masked_img'], flagship['i_train'],
            flagship['i_val'], flagship['all_angles'],
            flagship['all_periods'], percep, cx)
    plain = rank_proposals(*args, norm_res=flagship['norm_res'], device=dev)
    sharded, out['ranking'] = counted(lambda: rank_proposals(
        *args, norm_res=flagship['norm_res'], device=dev,
        mesh=make_mesh(('candidates',), group=group)))
    out['ranking'].update(plain=plain.tolist(), sharded=sharded.tolist())
    cfgs = [replace(SearchConfig(), datadir=f'suite{s}') for s in (0, 1, 2)]
    odgts, out['suite'] = counted(lambda: run_search_suite(
        cfgs, percep, cx, device=dev, save=False,
        datas=[synthetic_search_data(s) for s in (0, 1, 2)],
        mesh=make_mesh(('images',), group=group)))
    out['suite']['top3'] = [top3(o) for o in odgts]
    return out


def _within_spread(got, runs):
    """(excess, image, name): the largest excess of a parameter over the
    two runs' spread, in units of its tensor's largest value."""
    import numpy as np
    worst = (0.0, None, None)
    for j, g in enumerate(got):
        for k, v in g.items():
            a, b = runs[0][j][k], runs[1][j][k]
            lo, hi = np.minimum(a, b), np.maximum(a, b)
            excess = float(np.maximum(lo - v, v - hi).max(initial=0.0)) / \
                max(float(np.abs(a).max()), 1e-30)
            worst = max(worst, (excess, j, k), key=lambda t: t[0])
    return worst


def drive_multicard(batched_params, batched_ms, suite, entry):
    """(a) NCCL at the card count, (b) two gloo ranks sharing card 0, (c)
    scripts/torch_run_suite.py under torchrun; see the module note (phase
    17). batched_params: phase 13's two unsharded runs' parameters;
    batched_ms: their steady ms per step. Returns the per-rank records."""
    import functools
    import shutil
    import numpy as np
    import torch
    from npp_tpu_torch.config import CompletionConfig, SearchConfig, replace
    from npp_tpu_torch.models.trainer import COMPLETION_TASK
    from npp_tpu_torch.parallel.launch import spawn
    from npp_tpu_torch.parallel.runner import fit_images
    from npp_tpu_torch.utils.synthetic import synthetic_data
    from npp_tpu_torch.proposal.search import _prepare_search
    from npp_tpu_torch.utils.synthetic import synthetic_search_data
    torch.cuda.empty_cache()
    base = os.path.join(ROOT, 'npp_tpu_torch', 'build', 'multicard')
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    count = torch.cuda.device_count()
    prep = _prepare_search(replace(SearchConfig(), datadir='flagship'),
                           synthetic_search_data(0), torch.device('cuda'))
    flagship = {k: prep[k] for k in ('masked_img', 'i_train', 'i_val',
                                     'all_angles', 'all_periods')}
    flagship['norm_res'] = (prep['dh'], prep['dw'])
    n_cand = len(flagship['all_angles'])
    # the references: (a) stacks all three images on its one rank, as
    # phase 13's runs did; (b)'s ranks stack [0, 1] and [2, 2]. Stacks of
    # other sizes pick other cuBLAS and cuDNN algorithms, whose rounding
    # the CX term carries far in 20 Adam steps, so (b) is held to
    # unsharded fits of its ranks' blocks, and its distance from the
    # three-image runs is reported beside that of an unsharded [2, 2] fit
    cfg = replace(CompletionConfig(), N_iters=21, i_testset=10, i_print=10)
    datas = [synthetic_data(s) for s in (0, 1, 2)]
    blocks = host_params(fit_images(cfg, COMPLETION_TASK, datas[:2],
                                    device='cuda')) + \
        host_params(fit_images(cfg, COMPLETION_TASK, [datas[2]] * 2,
                               device='cuda'))[:1]
    refs = {'nccl': batched_params, 'gloo_two_ranks_one_card': [blocks] * 2}
    stacking, _, _ = _within_spread(blocks[2:], [r[2:] for r in
                                                 batched_params])
    log(f'multi-card: an unsharded fit of images [2, 2] lies {stacking:.3e} '
        f"of a tensor's largest value beyond phase 13's three-image runs")
    out, problems = {'stacking_excess_image2': stacking}, []
    for label, world, backend, kw in zip(MC_PATHS, (count, 2),
                                         ('nccl', 'gloo'),
                                         ({}, {'flagship': flagship})):
        t0 = time.time()
        ranks = spawn(functools.partial(_multicard_rank, **kw), world,
                      backend, os.path.join(base, f'init_{label}'),
                      timeout=MC_DEADLINE, cuda=True, threads=None)
        wall = time.time() - t0
        for r in ranks:
            f = r['fit']
            log(f"multi-card {label}, rank {r['rank']} on {r['device']} "
                f"({r['backend']}): fit of images {f['images']} "
                f"{f['wall_s']:.2f} s wall, steady {f['ms_per_step_steady']:.2f}"
                f" ms/step, peak {f['peak_bytes'] / 2**30:.2f} GiB, launches "
                f"{ {k: f['launches'].get(k, 0) for k in K_BASE} }; render "
                f"{r['render']}")
            for part in ('ranking', 'suite'):
                if part in r:
                    p = r[part]
                    log(f"multi-card {label}, rank {r['rank']} {part}: "
                        f"{p['wall_s']:.2f} s wall, peak "
                        f"{p['peak_bytes'] / 2**30:.2f} GiB, launches "
                        f"{ {k: p['launches'].get(k, 0) for k in K_BASE} }")
            for k in K_BASE:
                if f['launches'].get(k, 0) <= 0:
                    problems.append(f'{label}: rank {r["rank"]} launched no '
                                    f'{k} in its fit')
            if not (r['render']['bit_equal'] or
                    r['render']['max_abs_diff'] <= 1e-6) or \
                    not r['render']['finite']:
                problems.append(f'{label}: sharded render {r["render"]}')
            excess, j, name = _within_spread(r['params'], refs[label])
            three, _, _ = _within_spread(r['params'], batched_params)
            log(f"multi-card {label}, rank {r['rank']}: parameters beyond "
                f"the unsharded references' spread by at most {excess:.3e} "
                f"of the tensor's largest value (bar 1e-4; image {j} "
                f"{name}); beyond phase 13's three-image runs by {three:.3e}")
            if excess > 1e-4:
                problems.append(f'{label}: rank {r["rank"]} parameters '
                                f'{excess:.3e} beyond the unsharded spread')
            r['fit'].update(params_excess=excess,
                            params_excess_over_three_image_runs=three)
            del r['params']
        out[label] = {'world': world, 'wall_s': wall, 'ranks': ranks}
    ms = out['nccl']['ranks'][0]['fit']['ms_per_step_steady']
    out['nccl']['ms_per_step_over_unsharded'] = ms / batched_ms
    log(f'multi-card nccl: {ms:.2f} ms/step against phase 13\'s unsharded '
        f'{batched_ms:.2f} ({ms / batched_ms:.3f}x)')
    for r in out['gloo_two_ranks_one_card']['ranks']:
        rk, su = r['ranking'], r['suite']
        plain, sharded = np.asarray(rk['plain']), np.asarray(rk['sharded'])
        rel = float(np.max(np.abs(sharded - plain) / np.abs(plain)))
        rk['max_rel_diff'] = rel
        same3 = list(np.argsort(plain)[:3]) == list(np.argsort(sharded)[:3])
        log(f"multi-card ranking, rank {r['rank']}: {n_cand} candidates over "
            f'2 ranks (padded to {-(-n_cand // 2) * 2}), full f32: max rel '
            f'diff from the unsharded call {rel:.3e}, same top-3 {same3}')
        if rel > 1e-4 or not same3:
            problems.append(f'ranking: {sharded} against unsharded {plain}')
        for k in K_BASE[1:-1]:   # the ranking's eval runs no CX gradient
            if rk['launches'].get(k, 0) <= 0 or su['launches'].get(k, 0) <= 0:
                problems.append(f'ranking/suite: rank {r["rank"]} launched '
                                f'no {k}')
        same = su['top3'] == suite['top3']
        log(f"multi-card suite search, rank {r['rank']}: each image's top-3 "
            f"equals phase 14's: {same}")
        if not same:
            problems.append(f"suite search: top-3 {su['top3']} against "
                            f"phase 14's {suite['top3']}")
    if problems:
        fail(f'multi-card: {problems}')
    suite_in = os.path.join(ROOT, 'npp_tpu_torch', 'build', 'smoke_files',
                            'suite')
    tr_out = os.path.join(base, 'torchrun_out')
    _, wall = _run('torchrun torch_run_suite.py', [
        sys.executable, '-m', 'torch.distributed.run', '--standalone',
        f'--nproc-per-node={count}',
        os.path.join(ROOT, 'scripts', 'torch_run_suite.py'),
        '--input-root', suite_in, '--out', tr_out, '--tasks', 'completion',
        '--batched', '--batched-search', '--iters-scale', '0.0055'],
        timeout=300)
    with open(os.path.join(tr_out, 'summary.json')) as f:
        summary = json.load(f)
    recs, want = summary['tasks']['completion'], entry['suite']
    if sorted(recs) != sorted(want) or any(
            set(recs[n]) != set(want[n]) or
            recs[n]['top_periods'] != want[n]['top_periods'] for n in want):
        fail(f'torchrun suite summary {recs} against phase 15\'s {want}')
    log(f"multi-card entry point: torchrun with {count} rank(s), "
        f"{wall:.1f} s; records' keys and top-3 equal phase 15's")
    out['torchrun'] = {'world': summary['env']['world'], 'wall_s': wall,
                       'phases': summary['phases']}
    return out


def main():
    global PEAKS
    t0 = time.time()
    name, smi = phase_device()
    import torch
    from npp_tpu_torch.device import card_peaks, matmul_precision
    PEAKS = card_peaks(name)
    wgmma = phase_build()
    gen = torch.Generator().manual_seed(0)
    with matmul_precision('float32'):
        log('kernel checks and the fit steps: TF32 off '
            '(torch.backends.cuda.matmul.allow_tf32 = False, '
            'torch.backends.cudnn.allow_tf32 = False)')
        kernels = check_k1(gen) + check_k1_bwd(gen) + check_k2(gen) + \
            check_k4(gen) + check_k4_wide(gen) + check_k1_seg(gen) + \
            k2_entries(gen, SEG_K2, SEG_K2_NAMES) + check_k1_batched(gen) + \
            check_batch_kernels(gen) + check_k4_squeeze(gen) + \
            check_k3_all(gen)
        for k in kernels:
            err = (f"vs float64 kernel {k['rel_err_vs_f64']:.3e}, plain "
                   f"{k['plain_rel_err_vs_f64']:.3e} (tol {k['tol']:.3e})"
                   if 'tol' in k else
                   f"{k['max_bf16_ulps']:.2f} bf16 ulp, equals the f32 kernel "
                   f"rounded: {k['equals_f32_kernel_rounded']}")
            log(f"{k['name']}: max abs diff from plain {k['max_abs_err']:.3e}; "
                f"{err}; {k['ms']:.4f} ms (eager {k['eager_ms']:.4f}) vs "
                f"plain {k['plain_ms']:.4f} ms, bound {k['bound_us']:.1f} us "
                f"({k['bound_by']})")
            if k['name'].startswith('cx_chain'):
                log(f"  K3 passes (ms): {k['passes_ms']}; scratch bytes "
                    f"{k['scratch_bytes']}; product tiles "
                    f"{k['product_tiles']}")
                log(f"  K3 {k['precision']}: warm {k['warm_ms']:.4f} ms; "
                    + ', '.join(f'{x} {k[x]:.4g}' for x in (
                        'tie_mask_err_vs_plain', 'tf32_err_vs_plain',
                        'tf32_rel_err_vs_f64', 'tf32_plain_rel_err_vs_f64',
                        'tf32_tie_mask_err_vs_plain', 'plain_fwd_bwd_ms',
                        'dx_only_ms', 'ms_f32', 'plain_ms_f32',
                        'bound_ms_f32', 'peak_mib', 'plain_peak_mib')
                        if x in k))
            for seg in k.get('segments', ()):
                log(f"  alone at {seg['shape']}: {seg['ms']:.4f} ms (eager "
                    f"{seg['eager_ms']:.4f}), bound "
                    f"{1e3 * seg['bound_ms']:.1f} us")
        k3_forms = check_k3_forms(gen)
        bad = [k['name'] for k in kernels + k3_forms if not k['passed']]
        if bad:
            fail(f'kernels disagree with their plain versions: {bad}')
        steps = dict(check_fit_step(), remapping=check_remap_step(),
                     segmentation=check_seg_step(),
                     batched=check_batched_step())
        blur = check_blur_map()
        slic = check_slic()
        det, i_train, img = check_search_detection()
        check_search_step(det, i_train, img)
        inpaint = check_inpaint()
        squeeze_card_vs_cpu = check_lpips_squeeze()
    cosines = check_tf32_gradients()
    bf16_name = 'periodic_embed_bf16'
    on_search = set(search_names()) | k3_names(K3_SEARCH, ('fwd',))
    on_remap = {k['name'] for k in kernels if '[6x' in k['name'] and
                k['name'].startswith('robust_rho')} | k3_names(K3_PATCH64)
    on_warp = {'periodic_embed_bwd'}
    on_seg = seg_names()
    on_batch = batch_names() | k3_names(K3_BATCHED)
    on_suite = suite_names()
    on_squeeze = set(squeeze_names())
    log("main path and bf16-table path: matmul_precision='bfloat16' (the "
        "default), TF32 on in the steps and the render")
    main_launches, history, peak, _ = drive(
        'main path', [k['name'] for k in kernels
                      if k['name'] != bf16_name and k['name'] not in
                      on_search | on_remap | on_warp | on_seg | on_batch |
                      on_suite | on_squeeze],
        N_iters=21)
    bf16_launches, bf16_history, _, _ = drive(
        'bf16-table path', [bf16_name, 'bias_snake_fwd', 'bias_snake_bwd',
                            'robust_rho_fwd', 'robust_rho_bwd',
                            *sorted(k3_names(K3_FIT))],
        N_iters=11, embed_table='bfloat16')
    log("remapping, held-out and warp paths: the default RemappingConfig / "
        "CompletionConfig widths, TF32 in the steps and the render")
    remap_launches, remap = drive_remap()
    heldout = drive_heldout()
    warp_launches, warp = drive_warp()
    log("seam path: comp_seam='residual', the default CompletionConfig "
        "widths")
    _, seam = drive_seam()
    log("search path: the default SearchConfig (matmul_precision="
        "'bfloat16': TF32 in the fit; the eval in full f32)")
    odgt, stats, search_launches, search_peak = drive_search()
    chained = chained_data(odgt)
    log(f'search-chained path: the search\'s top-3 lattices '
        f'{chained.selected_angles} / {chained.selected_periods}, patch size '
        f'{chained.patch_size}')
    _, chained_history, _, chained_final = drive(
        'search-chained path', list(MAIN_KERNELS), data=chained, N_iters=11)
    log("segmentation path: the default SegmentationConfig widths, TF32 in "
        "the steps and the render, the refinement's spatial LPIPS-alex in "
        "full f32")
    seg_launches, seg = drive_segment()
    log("batched paths: fit_images at the default CompletionConfig widths, "
        "TF32 in the steps and the render")
    batch_launches, batched, batched_params = drive_batched()
    log("suite search: run_search_suite at the default SearchConfig")
    suite_launches, suite = drive_suite_search()
    log("entry points from files: cli search, cli complete and "
        "scripts/torch_run_suite.py in subprocesses on the card")
    entry = drive_entry_points()
    log("squeeze path: LPIPS-squeeze robust at the completion's robust "
        "batch, TF32 off")
    with matmul_precision('float32'):
        squeeze_launches, squeeze = drive_squeeze()
    log('weight sources: a .pth and a weights-dir npz on the card')
    weights = check_weight_sources()
    log('multi-card path: fit_images, make_sharded_render, rank_proposals '
        'and run_search_suite over torch.distributed ranks, and '
        'torch_run_suite.py under torchrun')
    multicard = drive_multicard(batched_params,
                                batched['batched']['ms_per_step_steady'],
                                suite, entry)
    log('harness: bench_torch.py (primary, late and control) and '
        'scripts/torch_eval_remapping.py in subprocesses on the card')
    bench = drive_bench()
    remap_eval = drive_remap_eval()
    for k in kernels:
        k['launches'] = (bf16_launches if k['name'] == bf16_name else
                         squeeze_launches if k['name'] in on_squeeze else
                         batch_launches if k['name'] in on_batch else
                         suite_launches if k['name'] in on_suite else
                         seg_launches if k['name'] in on_seg else
                         search_launches if k['name'] in on_search else
                         remap_launches if k['name'] in on_remap else
                         warp_launches if k['name'] in on_warp else
                         main_launches).get(k['name'], 0)
    for k in kernels:
        if k['name'].startswith('cx_chain'):
            k['path_launches'] = {
                label: counts.get(k['name'], 0) for label, counts in (
                    ('completion', main_launches),
                    ('bf16_table', bf16_launches),
                    ('remapping', remap_launches), ('warp', warp_launches),
                    ('search', search_launches),
                    ('segmentation', seg_launches),
                    ('batched', batch_launches), ('suite', suite_launches))}
    for k in kernels:
        base = k['name'].split('[')[0]
        k['multicard_launches'] = {
            f'{label}/{part}': [r[part]['launches'].get(base, 0)
                                for r in multicard[label]['ranks']]
            for label in MC_PATHS for part in ('fit', 'ranking', 'suite')
            if part in multicard[label]['ranks'][0]}
    log(f'all phases: {time.time() - t0:.1f} s')
    search = {k: v for k, v in stats.items() if k != 'fit_losses'}
    search.update(peak_bytes=search_peak,
                  fit_loss_first_last=[float(stats['fit_losses'][0]),
                                       float(stats['fit_losses'][-1])],
                  distances=odgt['rank_candidates']['scores']['reference'],
                  top3=[odgt['selected_shifts'][:3],
                        odgt['selected_angles'][:3],
                        odgt['selected_periods'][:3]])
    print(json.dumps({'kernels': kernels,
                      'fit': {'ms_per_step': [h['ms_per_step']
                                              for h in history],
                              'bf16_table_ms_per_step': [
                                  h['ms_per_step'] for h in bf16_history],
                              'peak_bytes': peak},
                      'remap': remap, 'heldout': heldout, 'warp': warp,
                      'seam': seam, 'inpaint_golden': inpaint,
                      'squeeze': dict(squeeze,
                                      card_vs_cpu=squeeze_card_vs_cpu),
                      'weight_sources': weights,
                      'blur_map': blur, 'steps_card_vs_cpu': steps,
                      'segmentation': seg, 'slic': slic,
                      'batched': batched, 'suite_search': suite,
                      'entry_points': entry, 'multicard': multicard,
                      'bench': bench, 'remap_eval': remap_eval,
                      'search': search,
                      'search_chained': {
                          'patch_size': chained.patch_size,
                          'ms_per_step': [h['ms_per_step']
                                          for h in chained_history],
                          'train_psnr': chained_final['train_psnr'],
                          'val_psnr': chained_final['val_psnr'],
                          'val_lpips': chained_final['val_lpips']},
                      'k3_forms': k3_forms, 'k3_wgmma_in_ptx': wgmma,
                      'tf32_gradient_cosine': cosines}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
