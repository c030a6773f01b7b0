"""Benchmark of the PyTorch port (`npp_tpu_torch`) on one CUDA card: the
completion fit-step throughput of `bench.py`'s flagship workload, on the
port's own path. `bench.py` measures the JAX package and stays as it is;
this is its counterpart, function for function.

    python3 bench_torch.py            (from the repository root, one card)

Workload: `npp_tpu_torch/utils/synthetic.py::synthetic_data(0)` (bench.py's
`_synthetic_data`: a 384x512 near-periodic image with an 80x100 hole and
three lattices) at the default CompletionConfig: 8,192 pixel rows plus two
160x160 fake patches, each against 3 real patches, per step; NPPNet D=8
W=512 on 1,386 embedding channels; the adaptive robust pixel loss, VGG19
CX every step, VGG16 LPIPS-robust on 'same' steps; Adam. The kernels (K1 to
K4) are built from the checkout on first use.

Segments, in order; any failure exits non-zero:
 - primary: `models/trainer.py::make_fit_block(..., block=50)` (the
   per-block canvas table, then 50 steps), one warm-up block, then 6
   measured blocks, each between two CUDA events with no host sync inside
   or between them. `value` = the 300 steps over the blocks' summed time;
 - batched: `parallel/runner.py::fit_images` on 3 copies with
   embed_table='bfloat16' and canvas_multiple=64, its eval and log cadence
   set to 50 so its blocks are the primary's (bench.py passes block=50):
   one 50-iteration warm-up call, one timed 300-iteration call
   (NPP_BENCH_BATCHED=0 skips it);
 - latency: 30 single steps (make_fit_block(..., block=1): no table, K1
   on the fly), each synced, for p10 / p50 / p90; `est_host_overhead_ms`
   is p50 less 1 / value (NPP_BENCH_LATENCY=0 skips it);
 - late: two more blocks of the primary, `iters_per_sec_late`. It is
   reported beside `value` and never folded into it: on a card of its own
   the larger of two readings would only pick the luckier one;
 - control (NPP_BENCH_CONTROL=0 skips it): the reference's step pattern in
   plain PyTorch on the same card, after the port's segments so they do not
   share it: precomputed (N, 1,386) embeddings gathered per step, a torch
   NPP-Net D=8 W=512, the adaptive robust pixel loss and the VGG19-relu3_4
   contextual patch loss, in a subprocess with PyTorch's default TF32
   flags (TF32 off for matmuls, on for convolutions); one warm-up step,
   then two repeats of 20 steps. `vs_baseline` = value over its iter/s.
   This baseline is the reference's own computation pattern run eagerly by
   PyTorch on the card, not a published figure.

FLOPs: the analytic count of bench.py (MLP forward and backward on 8,192 +
2 x 160^2 rows from the port's nn.Linear shapes, CX's VGG19 tower and its
similarity products, LPIPS-VGG16 weighted by the 0.2 'same'-batch
probability). `mfu` = achieved FLOP/s over the card's dense matmul peak for
cfg.matmul_precision (TF32 at the default 'bfloat16', f32 under 'float32'),
from `npp_tpu_torch/device.py::card_peaks`.

Output: the last stdout line is one JSON object with bench.py's keys
(`metric`, `value`, `unit`, `vs_baseline`, `achieved_tflops`, `mfu`,
`iters_per_sec_early`, `iters_per_sec_late`, `mfu_batched`,
`batched_aggregate_image_iters_per_sec`; a skipped segment's keys are
null). Diagnostics go to stderr, the last of them one JSON object: the
card's name and power limit (nvidia-smi), the precision and peak, the
FLOPs per step, the block times, peak memory, launch counts, the latency
percentiles and the control. Without a card it exits non-zero before any
metric line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

H, W = 384, 512
PATCH_SIZE = 160
PATCH_NUM = 2
TOPK = 3
BLOCK = 50            # steps per fit block
N_BLOCKS = 6          # measured blocks (300 steps) after one warm-up block
N_LATE = 2            # late re-measure blocks
N_SINGLE = 30         # single synced steps for the latency percentiles
N_BATCHED = 3         # images stacked in the batched segment
N_CONTROL = 20        # steps per timed repeat of the control (two repeats)
SAME_PROB = 0.2       # the sampler's 'same'-batch probability (LPIPS steps)

METRIC_KEYS = ('metric', 'value', 'unit', 'vs_baseline', 'achieved_tflops',
               'mfu', 'iters_per_sec_early', 'iters_per_sec_late',
               'mfu_batched', 'batched_aggregate_image_iters_per_sec')


T_START = time.perf_counter()


def _log(msg: str) -> None:
    print(f'[bench_torch] {time.perf_counter() - T_START:.1f}s {msg}',
          file=sys.stderr, flush=True)


def _enabled(var: str) -> bool:
    return os.environ.get(var, '1') != '0'


# ---- analytic FLOPs, bench.py's count from the port's parameter shapes --
# (cin, cout, cumulative downsample) of each 3x3 conv up to the taps:
# relu3_4 (CX, VGG19) and conv5_3 (LPIPS, VGG16)
VGG19_CX_CONVS = [(3, 64, 1), (64, 64, 1), (64, 128, 2), (128, 128, 2),
                  (128, 256, 4), (256, 256, 4), (256, 256, 4), (256, 256, 4)]
VGG16_LPIPS_CONVS = VGG19_CX_CONVS[:7] + [
    (256, 512, 8), (512, 512, 8), (512, 512, 8),
    (512, 512, 16), (512, 512, 16), (512, 512, 16)]


def conv_flops(convs, s: int) -> float:
    return float(sum(2 * (s // d) ** 2 * 9 * cin * cout
                     for cin, cout, d in convs))


def dense_flops(model, n_rows: int) -> float:
    """2 N in out for each nn.Linear of `model` (weights stored (out, in))."""
    from torch import nn
    return float(sum(2 * n_rows * m.weight.shape[0] * m.weight.shape[1]
                     for m in model.modules() if isinstance(m, nn.Linear)))


def analytic_flops_per_step(cfg, model) -> dict:
    """Matmul and convolution FLOPs of one flagship fit step (forward and
    backward = 3x forward where a gradient flows; the embedding and the
    element-wise work are left out): the MLP on N_rand + patch rows; CX's
    VGG19 to relu3_4 on the predicted (forward and backward) and the real
    (forward) patch stacks, and its similarity products; LPIPS's VGG16
    towers, weighted by the 'same'-batch probability."""
    n_rows = cfg.N_rand + PATCH_NUM * PATCH_SIZE ** 2
    pk = PATCH_NUM * cfg.num_real_patch_per_sample
    mlp = 3.0 * dense_flops(model, n_rows)
    cx = (3.0 + 1.0) * pk * conv_flops(VGG19_CX_CONVS, PATCH_SIZE)
    p = (PATCH_SIZE // 4) ** 2            # relu3_4 positions
    cx += 4.0 * 2 * pk * 256 * p * p      # CX similarity products
    lpips = SAME_PROB * (3.0 + 1.0) * pk * conv_flops(VGG16_LPIPS_CONVS,
                                                      PATCH_SIZE)
    return {'mlp': mlp, 'contextual': cx, 'perceptual': lpips,
            'total': mlp + cx + lpips}


# ---- the port's segments ------------------------------------------------
def timed_blocks(run_block, state, gen, n: int):
    """ms of each of `n` blocks, between CUDA events recorded back to back
    (one host sync, after the last); also the host wall of the n blocks."""
    import torch
    events = []
    t0 = time.perf_counter()
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run_block(state, gen)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [s.elapsed_time(e) for s, e in events], wall


def bench_primary(cfg, device):
    """The fit blocks of the flagship. Returns (iter/s, the primary's
    diagnostics, the context the later segments reuse)."""
    import torch
    from npp_tpu_torch.device import matmul_precision
    from npp_tpu_torch.kernels import launch_counts, reset_launches
    from npp_tpu_torch.models.pipeline import build_components, make_fit_consts
    from npp_tpu_torch.models.trainer import init_fit_state, make_fit_block
    from npp_tpu_torch.utils.synthetic import synthetic_data

    data = synthetic_data(0)
    t0 = time.perf_counter()
    with matmul_precision('float32'):     # the blocks set their own
        comps = build_components(cfg, data, device)
        state = init_fit_state(cfg, comps.model, comps.percep, device,
                               comps.style)
        consts = make_fit_consts(cfg, data, PATCH_SIZE, device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def block_of(n):
        return make_fit_block(cfg, comps.embedder, consts, comps.percep,
                              comps.contextual, PATCH_NUM, PATCH_SIZE, n)

    run_block = block_of(BLOCK)
    gen = torch.Generator().manual_seed(cfg.seed + 1)
    torch.cuda.reset_peak_memory_stats(device)
    _log(f'warm-up block ({BLOCK} steps; builds the kernels on first use)')
    t0 = time.perf_counter()
    with matmul_precision('float32'):
        run_block(state, gen)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reset_launches()
    with matmul_precision('float32'):
        block_ms, wall = timed_blocks(run_block, state, gen, N_BLOCKS)
    launches = {k: v for k, v in sorted(launch_counts().items()) if v}
    ips = BLOCK * N_BLOCKS / (sum(block_ms) / 1e3)
    _log(f'primary: {ips:.3f} it/s; block ms {block_ms}')
    diag = {'setup_s': setup_s, 'warmup_block_s': warm_s,
            'block': BLOCK, 'block_ms': block_ms,
            'block_ms_min': min(block_ms), 'block_ms_max': max(block_ms),
            'blocks_host_wall_s': wall,
            'peak_memory_bytes': torch.cuda.max_memory_allocated(device),
            'launches': launches}
    ctx = {'cfg': cfg, 'state': state, 'gen': gen, 'run_block': run_block,
           'block_of': block_of, 'model': comps.model}
    return ips, diag, ctx


def bench_late(ctx):
    """Two more blocks of the primary, late in the run: (iter/s, the
    blocks' ms)."""
    from npp_tpu_torch.device import matmul_precision
    with matmul_precision('float32'):
        block_ms, _ = timed_blocks(ctx['run_block'], ctx['state'],
                                   ctx['gen'], N_LATE)
    return BLOCK * N_LATE / (sum(block_ms) / 1e3), block_ms


def bench_latency(ctx, ips: float) -> dict:
    """Single steps, each synced: their wall percentiles and the host's
    share beyond the blocked step time."""
    import torch
    from npp_tpu_torch.device import matmul_precision
    step = ctx['block_of'](1)
    state, gen = ctx['state'], ctx['gen']
    lat = []
    with matmul_precision('float32'):
        t0 = time.perf_counter()
        step(state, gen)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        for _ in range(N_SINGLE):
            t0 = time.perf_counter()
            step(state, gen)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
    pct = {f'p{q}': float(np.percentile(lat, q)) * 1e3 for q in (10, 50, 90)}
    return {'single_step_first_s': first_s, 'single_steps': N_SINGLE,
            'step_latency_ms': pct,
            'dispatched_iters_per_sec': 1.0 / float(np.mean(lat)),
            'est_host_overhead_ms': pct['p50'] - 1e3 / ips}


def bench_batched(cfg, device) -> dict:
    """fit_images on N_BATCHED copies of the flagship with bf16 tables."""
    from npp_tpu_torch.config import replace
    from npp_tpu_torch.models.trainer import COMPLETION_TASK
    from npp_tpu_torch.parallel.runner import fit_images
    from npp_tpu_torch.utils.synthetic import synthetic_data

    bcfg = replace(cfg, embed_table='bfloat16', i_print=BLOCK,
                   i_testset=BLOCK)
    datas = [synthetic_data(0)] * N_BATCHED
    t0 = time.perf_counter()
    fit_images(bcfg, COMPLETION_TASK, datas, n_iters=BLOCK,
               canvas_multiple=64, device=device)
    warm_s = time.perf_counter() - t0
    iters = BLOCK * N_BLOCKS
    stats = {}
    t0 = time.perf_counter()
    fit_images(bcfg, COMPLETION_TASK, datas, n_iters=iters,
               canvas_multiple=64, device=device, stats=stats)
    wall = time.perf_counter() - t0
    bucket = stats['buckets'][0]
    return {'batched_b': N_BATCHED, 'batched_warmup_s': warm_s,
            'batched_wall_s': wall,
            'batched_ms_per_step_steady': bucket['ms_per_step_steady'],
            'batched_table': bucket['table'],
            'batched_aggregate_image_iters_per_sec':
                N_BATCHED * iters / wall}


# ---- the control: the reference's step pattern in plain PyTorch ---------
def control_step(device, h: int = H, w: int = W, patch: int = PATCH_SIZE,
                 patch_num: int = PATCH_NUM, topk: int = TOPK,
                 n_rand: int = 32 * 32 * 8, seed: int = 0):
    """One Adam step of the reference's pattern on `device`, as a closure:
    precomputed (h w, 1,386) embeddings gathered per step, the torch
    NPP-Net D=8 W=512, the adaptive robust pixel loss and the VGG19-relu3_4
    contextual loss on the predicted patches against random real ones
    (random VGG weights: only time is read from it)."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as F
    torch.manual_seed(seed)
    emb_dim, top1 = 1386, 462
    patch_px = patch_num * patch * patch

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.trunk = nn.ModuleList(
                [nn.Linear(top1, 512)] +
                [nn.Linear(512 + (top1 if i == 5 else 0), 512)
                 for i in range(1, 8)])  # layer 5 takes the skip concat
            self.f1 = nn.Linear(512, 512)
            self.scale = nn.Linear(emb_dim - top1 + 512, 512)
            self.f2 = nn.Linear(512, 512)
            self.pos = nn.Linear(1024, 256)
            self.rgb = nn.Linear(256, 3)

        def forward(self, e):
            inp = e[:, :top1]
            x = inp
            for i, lin in enumerate(self.trunk):
                x = lin(x)
                x = x + torch.sin(x) ** 2
                if i == 4:
                    x = torch.cat([inp, x], -1)
            f1 = self.f1(x)
            x = self.scale(torch.cat([f1, e[:, top1:]], -1))
            x = x + torch.sin(x) ** 2
            x = torch.cat([f1, self.f2(x)], -1)
            x = self.pos(x)
            x = x + torch.sin(x) ** 2
            return torch.sigmoid(self.rgb(x))

    layers = []
    for i, (cin, cout, _) in enumerate(VGG19_CX_CONVS):
        if i in (2, 4):
            layers.append(nn.MaxPool2d(2, 2))
        layers += [nn.Conv2d(cin, cout, 3, padding=1), nn.ReLU()]
    vgg = nn.Sequential(*layers).to(device)
    for prm in vgg.parameters():
        prm.requires_grad_(False)

    def cx_loss(x, y):
        fx, fy = vgg(x), vgg(y)
        n, c = fx.shape[:2]
        mu = fy.mean(dim=(0, 2, 3), keepdim=True)
        fx = F.normalize((fx - mu).reshape(n, c, -1), dim=1)
        fy = F.normalize((fy - mu).reshape(n, c, -1), dim=1)
        sim = torch.bmm(fx.transpose(1, 2), fy).clamp(0, 1)
        d = 1 - sim
        d = d / (d.min(dim=2, keepdim=True)[0] + 1e-5)
        wgt = torch.exp((1 - d) / 0.5)
        cx = wgt / wgt.sum(dim=2, keepdim=True)
        cx = cx.max(dim=1)[0].mean(dim=1)
        return -torch.log(cx + 1e-5).mean()

    net = Net().to(device)
    latent = nn.Parameter(torch.zeros(2, 3, device=device))
    opt = torch.optim.Adam(list(net.parameters()) + [latent], lr=5e-4)
    embeddings = torch.randn(h * w, emb_dim, device=device)
    target = torch.rand(h * w, 3, device=device)
    patches_gt = torch.rand(patch_num * topk, 3, patch, patch, device=device)

    def step():
        idx = torch.randint(0, h * w, (n_rand + patch_px,), device=device)
        pred = net(embeddings[idx])
        diff = pred[:n_rand] - target[idx[:n_rand]]
        alpha = torch.sigmoid(latent[0]) * 1.998 + 0.001
        scale = F.softplus(latent[1] + 0.5413) * (1 - 1e-5) + 1e-5
        sq = (diff / scale) ** 2
        beta = (alpha - 2).abs().clamp(min=1e-7)
        loss = ((beta / alpha.clamp(min=1e-7)) *
                ((sq / beta + 1) ** (alpha / 2) - 1)).mean()
        pred_patch = pred[n_rand:].reshape(patch_num, patch, patch, 3)
        pred_patch = pred_patch.permute(0, 3, 1, 2).repeat_interleave(topk, 0)
        loss = loss + 0.001 * cx_loss(pred_patch, patches_gt)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def run_control() -> dict:
    """The control on the card: one warm-up step, then two repeats of
    N_CONTROL steps, synced before each clock read."""
    import torch
    t0 = time.perf_counter()
    device = torch.device('cuda')
    step = control_step(device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    repeats = []
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(N_CONTROL):
            step()
        torch.cuda.synchronize()
        repeats.append(N_CONTROL / (time.perf_counter() - t0))
    return {'iters_per_sec': float(np.mean(repeats)), 'repeats': repeats,
            'steps_per_repeat': N_CONTROL, 'setup_s': setup_s,
            'warmup_step_s': warmup_s,
            'process_s': time.perf_counter() - T_START,
            'matmul_allow_tf32': torch.backends.cuda.matmul.allow_tf32,
            'cudnn_allow_tf32': torch.backends.cudnn.allow_tf32,
            'device': torch.cuda.get_device_name(0)}


def bench_control() -> dict:
    """run_control in a fresh process: PyTorch's default flags there, and
    nothing of the port's precision scope."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           '--control'], capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f'control exited {proc.returncode}:\n'
                           f'{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}')
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    reps = rec['repeats']
    rec['spread_pct'] = 100.0 * abs(reps[1] - reps[0]) / max(reps)
    return rec


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit('bench_torch.py: torch.cuda.is_available() is false; this '
                 'benchmark measures the port on a CUDA card and has no CPU '
                 'mode')
    from npp_tpu_torch.config import CompletionConfig
    from npp_tpu_torch.device import matmul_peak, resolve_device, smi_line

    device = resolve_device(None)
    name = torch.cuda.get_device_name(device)
    cfg = CompletionConfig()
    peak, peak_name = matmul_peak(name, cfg.matmul_precision)
    diag = {'device': name, 'nvidia_smi': smi_line(),
            'torch': torch.__version__, 'cuda': torch.version.cuda,
            'matmul_precision': cfg.matmul_precision,
            'mfu_peak': peak_name, 'mfu_peak_tflops': peak / 1e12}
    _log(f'{diag["nvidia_smi"]}; matmul_precision '
         f'{cfg.matmul_precision!r}: MFU against the dense {peak_name} peak, '
         f'{peak / 1e12:g} TFLOP/s')

    ips, diag['primary'], ctx = bench_primary(cfg, device)
    flops = analytic_flops_per_step(cfg, ctx['model'])
    diag['flops_per_step'] = flops
    achieved = ips * flops['total']

    batched = None
    if _enabled('NPP_BENCH_BATCHED'):
        _log(f'batched: fit_images on {N_BATCHED} images, bf16 tables')
        batched = bench_batched(cfg, device)
        batched['batched_achieved_tflops'] = \
            batched['batched_aggregate_image_iters_per_sec'] * \
            flops['total'] / 1e12
        diag['batched'] = batched
    if _enabled('NPP_BENCH_LATENCY'):
        _log(f'latency: {N_SINGLE} single synced steps')
        diag['latency'] = bench_latency(ctx, ips)
    ips_late, diag['late_block_ms'] = bench_late(ctx)
    _log(f'late: {ips_late:.3f} it/s (early {ips:.3f})')
    del ctx
    torch.cuda.empty_cache()
    control = None
    if _enabled('NPP_BENCH_CONTROL'):
        _log('control: the reference\'s step pattern in plain PyTorch on '
             'the card, in a subprocess')
        control = diag['control'] = bench_control()
        _log(f'control: {control["iters_per_sec"]:.3f} it/s, repeats '
             f'{control["repeats"]}, spread {control["spread_pct"]:.1f}%')

    out = {
        'metric': 'completion_fit_iters_per_sec',
        'value': ips,
        'unit': 'iter/s',
        'vs_baseline': ips / control['iters_per_sec'] if control else None,
        'achieved_tflops': achieved / 1e12,
        'mfu': achieved / peak,
        'iters_per_sec_early': ips,
        'iters_per_sec_late': ips_late,
        'mfu_batched': (batched['batched_aggregate_image_iters_per_sec'] *
                        flops['total'] / peak) if batched else None,
        'batched_aggregate_image_iters_per_sec':
            batched['batched_aggregate_image_iters_per_sec']
            if batched else None,
    }
    print(json.dumps(diag), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    if sys.argv[1:] == ['--control']:
        print(json.dumps(run_control()), flush=True)
    else:
        main()
