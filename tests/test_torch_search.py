"""Port parity on the CPU for the search's eval and for a whole search: the
ranking eval against the reference's golden numbers and npp_tpu's score
components (cx_mask_pad off and on), and a small run_search against
npp_tpu's with the same init, Fourier bands and pixel batches, whose record
the completion loader reads."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npp_tpu.config import SearchConfig as JaxSearchConfig
from npp_tpu.config import replace as jax_replace
from npp_tpu.losses.contextual import ContextualLoss as JaxContextualLoss
from npp_tpu.losses.lpips import LPIPS as JaxLPIPS
from npp_tpu.nn.embedder import gaussian_freq_bands as jax_bands
from npp_tpu.proposal import ranking as JR
from npp_tpu.proposal import search as JS
from npp_tpu.proposal import search_engine as JE
from npp_tpu_torch.config import CompletionConfig, SearchConfig, replace
from npp_tpu_torch.losses.contextual import ContextualLoss
from npp_tpu_torch.losses.lpips import LPIPS
from npp_tpu_torch.models.loaders import _topk_periodicity, load_completion
from npp_tpu_torch.proposal import ranking as TR
from npp_tpu_torch.proposal import features as TF
from npp_tpu_torch.proposal import search as TS
from npp_tpu_torch.proposal import search_engine as TE
from npp_tpu_torch.utils.convert import params_from_jax
from npp_tpu_torch.utils.io import write_gray, write_rgb
from npp_tpu_torch.utils.synthetic import synthetic_search_data
from tests.test_torch_detect import assert_same_up_to_ties
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, 'tests', 'goldens')
CPU = torch.device('cpu')
COMPONENTS = ('lpips_bbox', 'cx_bbox', 'lpips_comp', 'cx_comp', 'val_mse')


@pytest.fixture(scope='module')
def towers():
    """Both packages' LPIPS-vgg and VGG19-CX (the same analytic weights)."""
    return (LPIPS(CPU), ContextualLoss(CPU), JaxLPIPS(net='vgg'),
            JaxContextualLoss(use_vgg=True))


def _golden_scenario():
    """scripts/make_ranking_goldens.py's scenario and the reference's
    numbers, as tests/test_pipeline_parity.py reads them."""
    spec = importlib.util.spec_from_file_location(
        'mk_rank_goldens', os.path.join(ROOT, 'scripts',
                                        'make_ranking_goldens.py'))
    mk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mk)
    g = np.load(os.path.join(GOLDEN_DIR, 'ranking_parity.npz'))
    netd = int(g['cfg'][0])
    lin = {f'periodic_{i}': f'periodic_linears.{i}' for i in range(netd)}
    lin.update(feature1='feature_linear1', rgb='rgb_linear',
               pos_0='pos_linears.0')
    n = len(g['angles'])
    mlp = {k: {'kernel': np.broadcast_to(g[f'sd_{v}.weight'].T, (n,) + g[
        f'sd_{v}.weight'].T.shape), 'bias': np.broadcast_to(
        g[f'sd_{v}.bias'], (n,) + g[f'sd_{v}.bias'].shape)}
        for k, v in lin.items()}
    return mk, g, mlp


def _golden_cfg(g, cls, rep, **kw):
    netd, netw, n_rand, n_iters = [int(x) for x in g['cfg']]
    return rep(cls(), netdepth=netd, netwidth=netw, N_rand=n_rand,
               N_iters=n_iters, matmul_precision='float32',
               rank_pad_candidates=0, **kw)


def test_ranking_eval_reproduces_reference_golden(towers):
    """rank_proposals with params_override and bands_override reproduces
    tests/goldens/ranking_parity.npz, the reference's own eval numbers, as
    tests/test_pipeline_parity.py::test_ranking_eval_matches_reference
    holds npp_tpu to them (rtol 3e-3)."""
    mk, g, mlp = _golden_scenario()
    img = mk.scenario_image()
    i_train, i_val = mk.scenario_split()
    cfg = _golden_cfg(g, SearchConfig, replace, crop_bucket=0)
    d, comps = TR.rank_proposals(
        cfg, img, i_train, i_val, g['angles'].tolist(),
        g['periods'].tolist(), towers[0], towers[1],
        params_override=params_from_jax({'mlp': mlp}),
        bands_override=g['freq_bands'], return_components=True, device=CPU)
    np.testing.assert_allclose(d, g['init_incl'], rtol=3e-3, atol=1e-3)
    np.testing.assert_allclose(comps['lpips_bbox'], g['init_lpips_incl'],
                               rtol=3e-3, atol=1e-4)
    np.testing.assert_allclose(comps['cx_bbox'], g['init_cx_incl'],
                               rtol=3e-3, atol=1e-3)


@pytest.mark.parametrize('cx_mask_pad', [False, True])
def test_ranking_eval_components_match_npp_tpu(towers, cx_mask_pad):
    """All five components per candidate equal npp_tpu's on the same
    parameters and bands, with the 64-px crop bucket (whose zero expansion
    cx_mask_pad keeps out of the bbox CX) and cx_mask_pad off and on: f32
    on both sides, rtol 1e-4 (the convolutions reassociate)."""
    mk, g, mlp = _golden_scenario()
    img = mk.scenario_image()
    i_train, i_val = mk.scenario_split()
    kw = dict(crop_bucket=64, cx_mask_pad=cx_mask_pad)
    _, got = TR.rank_proposals(
        _golden_cfg(g, SearchConfig, replace, **kw), img, i_train, i_val,
        g['angles'].tolist(), g['periods'].tolist(), towers[0], towers[1],
        params_override=params_from_jax({'mlp': mlp}),
        bands_override=g['freq_bands'], return_components=True, device=CPU)
    _, want = JR.rank_proposals(
        _golden_cfg(g, JaxSearchConfig, jax_replace, **kw), img, i_train,
        i_val, g['angles'].tolist(), g['periods'].tolist(), towers[2],
        towers[3], params_override={'mlp': jax.tree.map(jnp.asarray, mlp)},
        bands_override=g['freq_bands'], return_components=True)
    for k in COMPONENTS:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4,
                                   err_msg=k)


SMALL = dict(netdepth=2, netwidth=32, N_rand=128, N_iters=20)


def _write_example(d, path):
    os.makedirs(path)
    write_rgb(os.path.join(path, 'masked_img.png'), d['masked_img'])
    write_rgb(os.path.join(path, 'gt_img.png'), d['gt_img'])
    write_gray(os.path.join(path, 'unknown_mask.png'), d['unknown_mask'])
    write_gray(os.path.join(path, 'valid_mask.png'), d['valid_mask'])


def test_run_search_matches_npp_tpu_and_feeds_completion(towers, tmp_path,
                                                         monkeypatch):
    """A small run_search (96x128 synthetic, depth 2, width 32, N_rand 128,
    20 steps) in both packages from the same PNGs.

    The port's detection gives npp_tpu's candidates up to proven ties
    (tests/test_torch_detect.py: here the shifts (dx, 0) and (-dx, 0),
    whose losses are equal but for the FFTs' rounding). Its ranking then
    runs on npp_tpu's candidates, from npp_tpu's init and Fourier bands,
    with npp_tpu's pixel batches (its RNG gives other numbers from the
    same seed), so only f32 rounding separates the two rankings: every
    candidate's score components within 1e-3 relative (Adam's normalised
    updates carry the f32 rounding of small gradients through the 20
    steps: 1.3e-4 measured), and the same top-1, whose lead over the
    second is above that tolerance. The record has every key of npp_tpu's;
    the completion loader reads the config.odgt that save=True writes."""
    import cv2  # noqa: F401  (save=True and the PNGs need it)
    d = synthetic_search_data(1, 96, 128)
    src = str(tmp_path / 'in' / 'ex')
    _write_example(d, src)
    jcfg = jax_replace(JaxSearchConfig(), datadir=src,
                       outdir=str(tmp_path / 'jax'), **SMALL)
    want = JS.run_search(jcfg, towers[2], towers[3])

    core = JR._rank_core(jcfg)
    p0 = jax.tree.map(lambda x: np.asarray(x)[None], core['params0'])
    bands = np.asarray(jax_bands(jax.random.PRNGKey(jcfg.seed),
                                 jcfg.multires))
    keys = jax.random.split(jax.random.PRNGKey(jcfg.seed + 1), jcfg.N_iters)
    draws = iter([])

    port_init = TR.init_rank_params

    def init(cfg, n_cand, device):
        params = port_init(cfg, n_cand, device)
        conv = params_from_jax(jax.tree.map(
            lambda x: np.repeat(x, n_cand, 0), p0))
        params.mlp.load_state_dict(conv['mlp'])
        params.adaptive_pix.load_state_dict(conv['adaptive_pix'])
        return params

    def draw(gen, n_pool, n_rand):
        nonlocal draws
        if not isinstance(draws, list):
            draws = [torch.tensor(np.asarray(jax.random.randint(
                k, (n_rand,), 0, n_pool))) for k in keys]
        return draws.pop(0)

    detected = []

    def detect(img, mask, **kw):
        detected.append(TE.search_periodicity_by_feat(img, mask, **kw))
        act, m = TF.im2act(img, mask)
        detected.append((act * TF.act2edge(act[:-1], m)[[0]], m))
        c = want['rank_candidates']
        return c['angles'], c['periods'], [[np.asarray(s) for s in pair]
                                           for pair in c['shifts']]

    monkeypatch.setattr(TS, 'search_periodicity_by_feat', detect)
    monkeypatch.setattr(TR, 'init_rank_params', init)
    monkeypatch.setattr(TR, 'gaussian_freq_bands',
                        lambda gen, n: torch.tensor(bands))
    monkeypatch.setattr(TR, 'draw_indices', draw)
    cfg = replace(SearchConfig(), datadir=src, outdir=str(tmp_path / 'port'),
                  **SMALL)
    got = TS.run_search(cfg, towers[0], towers[1], device=CPU, save=True)
    assert draws == []

    (a, p, sh), (act, m) = detected
    grids = [np.asarray(f(act[:-1].astype(np.float32),
                          m.astype(np.float32)))
             for f in (lambda x, y: TE.displacement_loss_grid(
                 torch.tensor(x), torch.tensor(y)),
                 JE.displacement_loss_grid)]
    c = want['rank_candidates']
    assert_same_up_to_ties((a, p, sh), (c['angles'], c['periods'],
                                        c['shifts']), *grids, *m.shape)
    assert set(got) == set(want)
    for k in COMPONENTS:
        np.testing.assert_allclose(got['rank_candidates']['components'][k],
                                   want['rank_candidates']['components'][k],
                                   rtol=1e-3, err_msg=k)
    assert got['selected_shifts'][0] == want['selected_shifts'][0]
    assert want['distances'][1] - want['distances'][0] > \
        2e-3 * want['distances'][0]
    shifts, angles, periods = _topk_periodicity(got, 3)
    assert shifts == got['selected_shifts'][:3]
    assert angles == got['selected_angles'][:3]

    data = load_completion(replace(CompletionConfig(),
                                   datadir=os.path.join(cfg.outdir, 'ex')))
    assert data.selected_shifts == got['selected_shifts'][:3]
    assert data.orig_shape == (96, 128)
    np.testing.assert_array_equal(
        data.masked_img[:96], np.uint8(np.clip(d['masked_img'], 0, 1) * 255)
        / 255)
