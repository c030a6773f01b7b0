"""The yardstick's arithmetic: the operations of one image-step, counted
from a configuration's published widths (never from the port's modules),
the work the fit kinds declare from them (fit_work), and the least times
of K2 and K3 from a kind's declared work items.

Counting rules (one image-step):
 - the MLP: forward 2 * rows * in * out for every dense layer, its
   backward twice that (the input gradient and the weight gradient),
   less the first layer's input gradient, which nothing needs (the
   embedding takes no gradient);
 - a frozen conv tower: its forward on the predicted and on the real
   stack, and on the predicted stack its input gradient (the weights take
   none), 2 * H * W * 9 * cin * cout a conv;
 - CX's similarity product 2 * N * P * Q * C, once forward and once for
   the gradient in x (the real side takes none);
 - the style loss's Grams 2 * C^2 * HW a sample and layer, forward on
   both stacks and its gradient on the predicted one;
 - LPIPS runs on 'same' batches only: its share is weighted by the
   sampler's 'same' probability.
The harness's tests add back what bench_torch.py also counts (every
tower and the MLP three times forward where a gradient flows, CX's
products four times) and hold the sum to its 1,745.6 GFLOP, so that the
widths here are the ones that count was made from.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
SAME_PROB = 0.2        # the sampler's 'same'-batch probability
# matmul_precision names under which the fit's f32 products run in TF32
TF32_PRECISIONS = ('bfloat16', 'default', 'fastest', 'tensorfloat32',
                   'bfloat16_3x', 'high')


def peaks(device_name: str) -> Dict[str, float]:
    """The card's published peaks (peaks.json); KeyError for a card the
    table does not hold."""
    with open(os.path.join(HERE, 'peaks.json')) as f:
        table = json.load(f)['cards']
    return table[device_name]


def tower_convs(blocks: Sequence[Sequence[int]], n_convs: int
                ) -> List[Tuple[int, int, int]]:
    """(cin, cout, downsample) of the first n_convs 3x3 convs of a VGG
    tower given as (convs per block, channels)."""
    out, cin, down = [], 3, 1
    for n, ch in blocks:
        for _ in range(n):
            out.append((cin, ch, down))
            cin = ch
        down *= 2
    return out[:n_convs]


def conv_flops(convs, size: int) -> float:
    return float(sum(2 * (size // d) ** 2 * 9 * cin * cout
                     for cin, cout, d in convs))


def mlp_layers(mlp: dict) -> List[Tuple[int, int]]:
    """(in, out) of NPP-Net's dense layers, in order."""
    top1 = mlp['embed_channels_per_lattice']
    aux = top1 * (mlp['lattices'] - 1)
    w, layers, d_in = mlp['width'], [], top1
    for i in range(mlp['depth']):
        layers.append((d_in, w))
        d_in = w + (top1 if i in mlp['skips'] else 0)
    layers += [(d_in, w), (w + aux, w), (w, w), (2 * w, w // 2),
               (w // 2, 3)]
    return layers


def snake_layers(mlp: dict) -> List[int]:
    """The widths of the layers followed by snake (K2): the trunk, the
    scale branch and the position head."""
    w = mlp['width']
    return [w] * mlp['depth'] + [w, w // 2]


def step_shapes(config: dict) -> dict:
    """The shapes of one image-step from the configuration file."""
    c = config['config']
    s = config['image']['patch_size']
    pk = c['patch_num'] * c['num_real_patch_per_sample']
    return {'rows': c['N_rand'] + c['patch_num'] * s * s, 'patch': s,
            'pk': pk}


def flops_per_image_step(config: dict) -> Dict[str, float]:
    """{'mlp', 'contextual', 'perceptual', 'style', 'total'} operations of
    one image-step (see the module note)."""
    sh = step_shapes(config)
    rows, s, pk = sh['rows'], sh['patch'], sh['pk']
    towers = config['towers']
    dense = [2.0 * rows * i * o for i, o in mlp_layers(config['mlp'])]
    out = {'mlp': 3.0 * sum(dense) - dense[0]}
    pred = 2.0
    out['contextual'] = out['perceptual'] = out['style'] = 0.0
    cx = towers.get('contextual')
    if cx:
        convs = tower_convs(cx['blocks'], cx['convs'])
        p = (s // cx['downsample']) ** 2
        prod = 2.0 * pk * cx['channels'] * p * p
        out['contextual'] = (pred + 1.0) * pk * conv_flops(convs, s) + \
            2.0 * prod
    lp = towers.get('perceptual')
    if lp:
        convs = tower_convs(lp['blocks'], lp['convs'])
        out['perceptual'] = SAME_PROB * (pred + 1.0) * pk * \
            conv_flops(convs, s)
    st = towers.get('style')
    if st:
        convs = tower_convs(st['blocks'], st['convs'])
        grams = sum(2.0 * ch * ch * (s // d) ** 2 for ch, d in st['taps'])
        out['style'] = (pred + 1.0) * pk * (conv_flops(convs, s) + grams)
    out['total'] = sum(out.values())
    return out


def fit_work(config: dict, images: int) -> dict:
    """The work of a fit of `images` stacked images, as a kind declares it
    (programs/__init__.py): the operations of one image-step, the peak its
    products run at (TF32 under the TF32 matmul precisions, else f32), and
    the kernels' work items of one step: K2 on every snake layer over the
    step's rows, K3 at N = images x patches x real patches per patch
    samples of P = Q = (patch / downsample)^2 positions, its gradient in x
    only (the real side takes none), in TF32."""
    sh = step_shapes(config)
    peak = 'tf32' if config['config']['matmul_precision'] in TF32_PRECISIONS \
        else 'f32'
    kernels = {'K2': [{'rows': images * sh['rows'], 'width': w,
                       'precision': 'f32'}
                      for w in snake_layers(config['mlp'])]}
    cx = config['towers'].get('contextual')
    if cx:
        p = (sh['patch'] // cx['downsample']) ** 2
        kernels['K3'] = [{'n': images * sh['pk'], 'p': p, 'q': p,
                          'c': cx['channels'], 'dx': True, 'dy': False,
                          'masked': False, 'precision': 'tf32'}]
    return {'flops': flops_per_image_step(config), 'peak': peak,
            'kernels': kernels}


def work_of(ctx) -> dict:
    """The run's declared work, ctx.work (the kind's `work`). A context
    that carries none, as the readers' first test builds one by hand
    around a fit's configuration, is given the fits' own."""
    work = getattr(ctx, 'work', None)
    return fit_work(ctx.config, ctx.images) if work is None else work


def kernel_items(ctx, kernel: str) -> list:
    """The work items of `kernel` ('K2', 'K3') the run declares; empty
    where it declares none."""
    return work_of(ctx).get('kernels', {}).get(kernel) or []


# ---- least times ------------------------------------------------------------


def least_time(ops: float, nbytes: float, peak_ops: float,
               peak_bytes: float) -> float:
    return max(ops / peak_ops, nbytes / peak_bytes)


def k2_bounds(rows: int, width: int, pk: Dict[str, float],
              precision: str = 'f32') -> Tuple[float, float]:
    """(forward s, backward s) of K2 on (rows, width): the forward reads
    the product and the bias and writes the activation, the backward reads
    the upstream gradient, the product and the bias and writes the input
    gradient (4-byte values; the bias's gradient is a sum outside K2); its
    operations over the `precision` peak."""
    mn, n = float(rows) * width, float(width)
    fwd = least_time(5.0 * mn, 4.0 * (2 * mn + n), pk[precision],
                     pk['hbm_bytes_per_s'])
    bwd = least_time(8.0 * mn, 4.0 * (3 * mn + n), pk[precision],
                     pk['hbm_bytes_per_s'])
    return fwd, bwd


def k2_least(item: dict, pk: Dict[str, float]) -> float:
    """Least seconds a step of one K2 work item {'rows', 'width',
    'precision', 'per_step'}: forward and backward."""
    fwd, bwd = k2_bounds(item['rows'], item['width'], pk,
                         item.get('precision', 'f32'))
    return (fwd + bwd) * item.get('per_step', 1)


def k3_bounds(n: int, p: int, q: int, c: int, pk: Dict[str, float],
              need_dx: bool = True, need_dy: bool = False,
              mask: bool = False, precision: str = 'tf32'
              ) -> Tuple[float, float]:
    """(forward s, backward s) of K3 at N samples of P x Q positions and C
    channels, its products at the `precision` peak (TF32 in the fits, f32
    FFMA in the search's eval): the forward reads xn, yn (and the mask)
    and writes z, one product; the backward reads xn, yn and g and writes
    each gradient asked for, one product each."""
    xb, yb = 4.0 * n * p * c, 4.0 * n * q * c
    prod = 2.0 * n * p * q * c
    fwd = least_time(prod, xb + yb + 4.0 * n * q + (4.0 * n * p if mask
                                                    else 0.0),
                     pk[precision], pk['hbm_bytes_per_s'])
    outs = (xb if need_dx else 0.0) + (yb if need_dy else 0.0)
    bwd = least_time(prod * (int(need_dx) + int(need_dy)),
                     xb + yb + 4.0 * n * q + outs, pk[precision],
                     pk['hbm_bytes_per_s'])
    return fwd, bwd


def k3_least(item: dict, pk: Dict[str, float]) -> float:
    """Least seconds a step of one K3 work item {'n', 'p', 'q', 'c', 'dx',
    'dy', 'masked', 'precision', 'per_step'}: the forward, and the
    backward where a gradient is wanted."""
    fwd, bwd = k3_bounds(item['n'], item['p'], item['q'], item['c'], pk,
                         need_dx=item['dx'], need_dy=item['dy'],
                         mask=item['masked'],
                         precision=item.get('precision', 'tf32'))
    return (fwd + (bwd if item['dx'] or item['dy'] else 0.0)) * \
        item.get('per_step', 1)
