"""The suite search on the CPU: rank_proposals_suite against npp_tpu's on
two small images (the same init, Fourier bands and pixel draws), against
the port's own one-image ranking, run_search_suite's records, and
scripts/torch_run_suite.py end to end on two tiny PNG examples.

Tolerance: every score component within 1e-3 relative (20 Adam steps
carry the f32 rounding of stacked products: the one-image search's test
holds the same bound, tests/test_torch_search.py)."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from npp_tpu.config import SearchConfig as JaxSearchConfig
from npp_tpu.config import replace as jax_replace
from npp_tpu.nn.embedder import gaussian_freq_bands as jax_bands
from npp_tpu.proposal import ranking as JR
from npp_tpu_torch.config import SearchConfig, replace
from npp_tpu_torch.proposal import ranking as TR
from npp_tpu_torch.proposal import search as TS
from npp_tpu_torch.proposal.pseudo_mask import build_pseudo_split
from npp_tpu_torch.proposal.search_engine import search_periodicity_by_feat
from npp_tpu_torch.utils.convert import params_from_jax
from npp_tpu_torch.utils.synthetic import synthetic_search_data
from tests.test_torch_search import COMPONENTS, SMALL, _write_example, towers  # noqa: F401
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device('cpu')
SIZES = ((64, 80), (64, 96))


def _items():
    """Two images on the suite's shared 64x96 canvas, each with its own
    detected candidates, pseudo-split and tight dims."""
    items = []
    for seed, (h, w) in zip((1, 2), SIZES):
        d = synthetic_search_data(seed, h, w)
        a, p, _ = search_periodicity_by_feat(
            np.uint8(d['masked_img'] * 255),
            np.uint8(d['valid_mask'] * d['unknown_mask'])[..., 0],
            repeat_range=(1, 10, 1))
        _, i_train, i_val = build_pseudo_split(d['unknown_mask'],
                                               d['valid_mask'])
        pad = ((0, 64 - h), (0, 96 - w), (0, 0))
        items.append({'masked_img': np.pad(d['masked_img'], pad),
                      'i_train': i_train, 'i_val': i_val, 'all_angles': a[:4],
                      'all_periods': p[:4], 'norm_res': (h, w)})
    return items


def test_rank_proposals_suite_matches_npp_tpu(towers, monkeypatch):  # noqa: F811
    jcfg = jax_replace(JaxSearchConfig(), **SMALL)
    cfg = replace(SearchConfig(), **SMALL)
    items = _items()
    want = JR.rank_proposals_suite(jcfg, items, towers[2], towers[3])

    core = JR._rank_core(jcfg)
    p0 = jax.tree.map(lambda x: np.asarray(x)[None], core['params0'])
    keys = jax.random.split(jax.random.PRNGKey(jcfg.seed + 1), jcfg.N_iters)
    calls = []

    def init(cfg_, n, device):
        params = port_init(cfg_, n, device)
        conv = params_from_jax(jax.tree.map(lambda x: np.repeat(x, n, 0), p0))
        params.mlp.load_state_dict(conv['mlp'])
        params.adaptive_pix.load_state_dict(conv['adaptive_pix'])
        return params

    def draw(gen, n_pool, n_rand):
        # npp_tpu's draw: the step's key for every image, bounded by each
        # image's own pool
        step = len(calls) // len(items)
        calls.append(n_pool)
        return torch.tensor(np.asarray(jax.random.randint(
            keys[step], (n_rand,), 0, n_pool)))

    port_init = TR.init_rank_params
    monkeypatch.setattr(TR, 'init_rank_params', init)
    monkeypatch.setattr(TR, 'draw_indices', draw)
    monkeypatch.setattr(TR, 'gaussian_freq_bands', lambda gen, n: torch.tensor(
        np.asarray(jax_bands(jax.random.PRNGKey(jcfg.seed), jcfg.multires))))
    got = TR.rank_proposals_suite(cfg, items, towers[0], towers[1],
                                  device=CPU)
    assert len(calls) == len(items) * cfg.N_iters
    for (gd, gc), (wd, wc) in zip(got, want):
        for k in COMPONENTS:
            np.testing.assert_allclose(gc[k], wc[k], rtol=1e-3, err_msg=k)
        np.testing.assert_allclose(gd, wd, rtol=1e-3)


def test_rank_proposals_suite_matches_port_sequential(towers):  # noqa: F811
    """Each image's distances from the suite's lockstep fit equal its own
    one-image rank_proposals (the same init, bands and draws by
    construction)."""
    cfg = replace(SearchConfig(), **SMALL)
    items = _items()
    stats = {}
    got = TR.rank_proposals_suite(cfg, items, towers[0], towers[1],
                                  device=CPU, stats=stats)
    assert stats['fit_losses'].shape == (cfg.N_iters,)
    for it, (gd, gc) in zip(items, got):
        h, w = it['norm_res']
        wd, wc = TR.rank_proposals(
            cfg, it['masked_img'][:h, :w], it['i_train'], it['i_val'],
            it['all_angles'], it['all_periods'], towers[0], towers[1],
            norm_res=it['norm_res'], return_components=True, device=CPU)
        assert gd.shape == (len(it['all_angles']),)
        for k in COMPONENTS:
            np.testing.assert_allclose(gc[k], wc[k], rtol=1e-3, err_msg=k)


def test_run_search_suite_records(towers, tmp_path):  # noqa: F811
    """run_search_suite writes one record per image with every key of
    run_search's, and the same top lattices as each image's one-image
    search."""
    cfgs, datas = [], []
    for seed, (h, w) in zip((1, 2), SIZES):
        datas.append(synthetic_search_data(seed, h, w))
        cfgs.append(replace(SearchConfig(), datadir=f'/x/ex{seed}',
                            outdir=str(tmp_path), **SMALL))
    stats = {}
    got = TS.run_search_suite(cfgs, towers[0], towers[1], device=CPU,
                              datas=datas, save=False, stats=stats)
    assert {'detect_s', 'rank_s', 'total_s', 'fit_s'} <= set(stats)
    for cfg, d, rec in zip(cfgs, datas, got):
        want = TS.run_search(cfg, towers[0], towers[1], device=CPU, data=d,
                             save=False)
        assert set(rec) == set(want)
        assert rec['selected_periods'][:3] == want['selected_periods'][:3]
        np.testing.assert_allclose(rec['distances'], want['distances'],
                                   rtol=1e-3)


def test_torch_run_suite_script_on_the_cpu(tmp_path):
    """scripts/torch_run_suite.py --batched --batched-search on two tiny
    examples: a summary with each image's metrics and its output PNGs."""
    root = tmp_path / 'in'
    for seed, (h, w) in zip((1, 2), SIZES):
        _write_example(synthetic_search_data(seed, h, w),
                       str(root / 'completion' / 'input' / f'ex{seed}'))
    out = tmp_path / 'out'
    cmd = [sys.executable, os.path.join(ROOT, 'scripts', 'torch_run_suite.py'),
           '--device', 'cpu', '--input-root', str(root), '--out', str(out),
           '--tasks', 'completion', '--batched', '--batched-search',
           '--iters-scale', '0.005', '--rank-iters', '5',
           '--set', 'netwidth=32', '--set', 'netdepth=2',
           '--set', 'N_rand=64', '--set', 'patch_num=1',
           '--set', 'num_real_patch_per_sample=2']
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='2')
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(out / 'summary.json') as f:
        summary = json.load(f)
    recs = summary['tasks']['completion']
    assert set(recs) == {'ex1', 'ex2'}
    for name, rec in recs.items():
        assert np.isfinite(rec['val_psnr']) and np.isfinite(rec['val_lpips'])
        assert 'top_periods' in rec
        final = out / 'completion' / 'results' / 'completion_top3' / \
            name / 'testset_final' / 'pred_rgb_img_comp.png'
        assert final.exists(), final
    assert summary['options']['batched'] and \
        summary['options']['batched_search']
