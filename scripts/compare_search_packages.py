#!/usr/bin/env python
"""Does npp_tpu pick the port's lattices? Run each package's default
search on utils/synthetic.py's search image and compare the records.

Usage:
  # one package's default search, its record written as JSON
  python scripts/compare_search_packages.py run --pkg jax --out a.json \
      [--seed 0] [--h 384 --w 512]
  python scripts/compare_search_packages.py run --pkg torch --out b.json \
      [--device cpu|cuda]
  # the port on the CPU with npp_tpu's init, Fourier bands and pixel
  # batches patched in (imports both packages)
  python scripts/compare_search_packages.py run --pkg torch-jax-draws \
      --out c.json
  # the comparison of two records
  python scripts/compare_search_packages.py compare a.json b.json

`--pkg jax` runs npp_tpu (JAX on the CPU here: `env JAX_PLATFORMS=cpu`;
it reads the example from PNGs, written with the port's own codec);
`--pkg torch` runs npp_tpu_torch on `--device` (default: the card), from
the same arrays in memory. Neither run is patched: each package draws its
own init, Fourier bands and pixel batches from the config's seed, so the
distances differ by the fits' randomness, not only by rounding.
`--pkg torch-jax-draws` takes those three from npp_tpu (as
tests/test_torch_search.py does at a small size), so that only f32
rounding separates its distances from npp_tpu's. The
comparison prints the candidates (angle, period, shifts) of each record,
their rank in each, and the relative difference of the distances.
"""
import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

KEYS = ('selected_angles', 'selected_periods', 'selected_shifts',
        'distances')


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def _write_example(args):
    """The synthetic example's four PNGs (the port's codec) in a new
    temporary directory; returns (that directory, the example's dir)."""
    from npp_tpu_torch.utils.io import write_gray, write_rgb
    from npp_tpu_torch.utils.synthetic import synthetic_search_data
    data = synthetic_search_data(args.seed, args.h, args.w)
    tmp = tempfile.mkdtemp()
    src = os.path.join(tmp, 'in', 'synthetic')
    os.makedirs(src)
    write_rgb(os.path.join(src, 'masked_img.png'), data['masked_img'])
    write_rgb(os.path.join(src, 'gt_img.png'), data['gt_img'])
    write_gray(os.path.join(src, 'unknown_mask.png'), data['unknown_mask'])
    write_gray(os.path.join(src, 'valid_mask.png'), data['valid_mask'])
    return tmp, src


def run(args):
    tmp, src = _write_example(args)
    t0 = time.time()
    if args.pkg == 'jax':
        from npp_tpu.config import SearchConfig, replace
        from npp_tpu.proposal.search import run_search
        cfg = replace(SearchConfig(), datadir=src,
                      outdir=os.path.join(tmp, 'out'))
        odgt = run_search(cfg)
        env = {'package': 'npp_tpu', 'device': 'jax ' + __import__(
            'jax').devices()[0].platform}
    else:
        import torch
        if args.pkg == 'torch-jax-draws':
            _patch_jax_draws()
        from npp_tpu_torch.config import SearchConfig, replace
        from npp_tpu_torch.device import resolve_device
        from npp_tpu_torch.proposal.search import run_search
        device = resolve_device(args.device)
        cfg = replace(SearchConfig(), datadir=src,
                      outdir=os.path.join(tmp, 'out'))
        odgt = run_search(cfg, device=device, save=False)
        env = {'package': 'npp_tpu_torch' + (
            ' (npp_tpu draws)' if args.pkg == 'torch-jax-draws' else ''),
            'device': str(device)}
        if device.type == 'cuda':
            env['device_name'] = torch.cuda.get_device_name(device)
    rec = {k: odgt[k] for k in KEYS}
    rec['rank_candidates'] = odgt.get('rank_candidates')
    rec.update(env, wall_s=time.time() - t0, seed=args.seed,
               shape=[args.h, args.w])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(_jsonable(rec), f, indent=1)
    print(json.dumps({k: _jsonable(rec[k]) for k in KEYS}))


def _patch_jax_draws():
    """The port's ranking takes npp_tpu's init, Fourier bands and pixel
    batches for the default SearchConfig (CPU)."""
    import jax
    import torch
    from npp_tpu.config import SearchConfig as JaxSearchConfig
    from npp_tpu.nn.embedder import gaussian_freq_bands as jax_bands
    from npp_tpu.proposal import ranking as JR
    from npp_tpu_torch.proposal import ranking as TR
    from npp_tpu_torch.utils.convert import params_from_jax
    jcfg = JaxSearchConfig()
    p0 = jax.tree.map(lambda x: np.asarray(x)[None],
                      JR._rank_core(jcfg)['params0'])
    bands = np.asarray(jax_bands(jax.random.PRNGKey(jcfg.seed),
                                 jcfg.multires))
    keys = jax.random.split(jax.random.PRNGKey(jcfg.seed + 1), jcfg.N_iters)
    draws = []
    port_init = TR.init_rank_params

    def init(cfg, n_cand, device):
        params = port_init(cfg, n_cand, device)
        conv = params_from_jax(jax.tree.map(
            lambda x: np.repeat(x, n_cand, 0), p0))
        params.mlp.load_state_dict(conv['mlp'])
        params.adaptive_pix.load_state_dict(conv['adaptive_pix'])
        return params

    def draw(gen, n_pool, n_rand):
        if not draws:
            draws.extend(torch.tensor(np.asarray(jax.random.randint(
                k, (n_rand,), 0, n_pool))) for k in keys)
        return draws.pop(0)

    TR.init_rank_params = init
    TR.gaussian_freq_bands = lambda gen, n: torch.tensor(bands)
    TR.draw_indices = draw


def _cands(rec):
    def r4(v):
        return tuple(round(float(x), 4) for x in v)
    return [(r4(a), r4(p), json.dumps(s)) for a, p, s in zip(
        rec['selected_angles'], rec['selected_periods'],
        rec['selected_shifts'])]


def compare(a_path, b_path):
    with open(a_path) as f:
        a = json.load(f)
    with open(b_path) as f:
        b = json.load(f)
    ca, cb = _cands(a), _cands(b)
    print(f"A: {a['package']} on {a['device']}, {a['wall_s']:.1f} s; "
          f"B: {b['package']} on {b['device']}, {b['wall_s']:.1f} s")
    print('rank  A: angle, periods, distance        '
          'B: angle, periods, distance        rel. diff')
    for i in range(max(len(ca), len(cb))):
        la = (f'{ca[i][0]} {ca[i][1]} {a["distances"][i]:.6f}'
              if i < len(ca) else '')
        lb = (f'{cb[i][0]} {cb[i][1]} {b["distances"][i]:.6f}'
              if i < len(cb) else '')
        rel = ''
        if i < len(ca) and ca[i] in cb:
            j = cb.index(ca[i])
            rel = (f'B rank {j}, '
                   f'{abs(a["distances"][i] - b["distances"][j]) / abs(a["distances"][i]):.3e}')
        print(f'{i:4d}  {la:34s} {lb:34s} {rel}')
    same_set = sorted(ca) == sorted(cb)
    out = {'same_candidates': same_set, 'same_order': ca == cb,
           'same_top1': ca[:1] == cb[:1], 'same_top3': ca[:3] == cb[:3]}
    print(json.dumps(out))
    return out


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest='cmd', required=True)
    r = sub.add_parser('run')
    r.add_argument('--pkg', choices=['jax', 'torch', 'torch-jax-draws'],
                   required=True)
    r.add_argument('--out', required=True)
    r.add_argument('--seed', type=int, default=0)
    r.add_argument('--h', type=int, default=384)
    r.add_argument('--w', type=int, default=512)
    r.add_argument('--device', default=None)
    c = sub.add_parser('compare')
    c.add_argument('a')
    c.add_argument('b')
    args = ap.parse_args()
    if args.cmd == 'run':
        run(args)
    else:
        compare(args.a, args.b)


if __name__ == '__main__':
    main()
