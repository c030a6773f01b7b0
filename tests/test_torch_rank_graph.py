"""The search's lockstep fit as one CUDA graph (proposal/ranking.py::
_fit_on_card) against the step loop it replaces.

On the CPU: the block of draws a card's fit makes up front is, bit for
bit, what the loop's per-step draw_indices calls give, and a capture's
launches are counted once for each replay and not for the capture. On the
card (marker `cuda`; this file imports no JAX): at the flagship search's
shapes (9 candidates x 2,048 rows, 300 steps) the graph's fit against an
eager copy of the loop kept here: its first steps, its losses, its
launch counts, its spans, no sync in its replays, the memory it leaves,
the search's top-3, the suite's fit, and a fit too short to capture. Run
the card tests with
`python -m pytest --noconftest -m cuda tests/test_torch_rank_graph.py`."""
import collections

import numpy as np
import pytest
import torch

from npp_tpu_torch import kernels
from npp_tpu_torch.config import SearchConfig
from npp_tpu_torch.device import matmul_precision
from npp_tpu_torch.models.trainer import make_schedule
from npp_tpu_torch.nn.embedder import gaussian_freq_bands
from npp_tpu_torch.proposal import ranking, search
from npp_tpu_torch.utils import debug
from npp_tpu_torch.utils.synthetic import synthetic_search_data

N_RAND = 64


@pytest.mark.parametrize('pool_sizes', [(500,), (500, 301, 1_000)])
def test_the_block_of_draws_is_the_loops_draws(pool_sizes):
    pools = [torch.zeros(n, 2, dtype=torch.long) for n in pool_sizes]

    def gens():
        return [torch.Generator().manual_seed(7 + j)
                for j in range(len(pools))]
    block = ranking.draw_block(pools, gens(), N_RAND, 5)
    loop_gens = gens()
    loop = [[ranking.draw_indices(g, len(p), N_RAND)
             for p, g in zip(pools, loop_gens)] for _ in range(5)]
    assert block.shape == (5, len(pools), N_RAND)
    assert block.dtype == torch.long
    for s in range(5):
        for j in range(len(pools)):
            assert torch.equal(block[s, j], loop[s][j])


def test_a_capture_counts_at_each_replay_and_not_at_the_capture(monkeypatch):
    for mod in kernels._MODULES:
        monkeypatch.setattr(mod, 'LAUNCHES', collections.Counter(
            {k: 1 for k in mod.LAUNCHES}))
    before = kernels.launch_counts()
    fwd, bwd = 'bias_snake_fwd[9x2048x256]', 'robust_rho_bwd[2048x27]'

    def capture():
        kernels.snake.LAUNCHES[fwd] += 4
        kernels.robust_rho.LAUNCHES[bwd] += 1
    delta = kernels.captured_launches(capture)
    assert {k: v for k, v in kernels.launch_counts().items() if v} == before
    for _ in range(3):
        kernels.add_launches(delta)
    after = kernels.launch_counts()
    assert after[fwd] == 12 and after['bias_snake_fwd'] == 12
    assert after[bwd] == 3 and after['robust_rho_bwd'] == 3
    assert {k: v for k, v in after.items()
            if k not in (fwd, bwd, 'bias_snake_fwd', 'robust_rho_bwd')} == \
        before


# ---- on the card ----------------------------------------------------------


def eager_fit(params, lats, imgs, pools, gens, angles, periods, n_iters):
    """The step loop that ran on the card before the graph, as it was: one
    draw and one blocking copy a step, Adam with a float learning rate."""
    cfg = lats[0].cfg
    opt = torch.optim.Adam(params.parameters(), lr=cfg.lrate,
                           betas=(0.9, 0.999), eps=1e-8)
    schedule = make_schedule(cfg)
    nb, n_cand = angles.shape[:2]
    bi = torch.arange(nb, device=imgs.device)[:, None]
    losses = []
    with matmul_precision(cfg.matmul_precision):
        for step in range(n_iters):
            for group in opt.param_groups:
                group['lr'] = schedule(step)
            idx = [ranking.draw_indices(g, len(pool), cfg.N_rand)
                   for pool, g in zip(pools, gens)]
            idx = [i.to(pool.device) for i, pool in zip(idx, pools)]
            pix = torch.stack([pool[i] for pool, i in zip(pools, idx)])
            gt = imgs[bi, pix[..., 0], pix[..., 1]]
            opt.zero_grad(set_to_none=True)
            loss = ranking.lockstep_loss(params, lats, pix.to(torch.float32),
                                         gt, angles, periods)
            loss.backward()
            opt.step()
            losses.append(loss.detach() / (nb * n_cand))
    return torch.stack(losses)


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.fixture(scope='module')
def flagship(card):
    """The flagship search's candidates, lattices, image and pool."""
    cfg = SearchConfig()
    prep = search._prepare_search(cfg, synthetic_search_data(0), card)
    bands = gaussian_freq_bands(torch.Generator().manual_seed(cfg.seed),
                                cfg.multires)
    lat = ranking.Lattices(cfg, prep['all_angles'], prep['all_periods'],
                           bands, (prep['dh'], prep['dw']), card)
    img = torch.as_tensor(prep['masked_img'], dtype=torch.float32,
                          device=card)
    pool = torch.as_tensor(prep['i_train'], dtype=torch.long, device=card)
    return cfg, lat, img, pool


def fit(fn, flagship, n_iters, device):
    """fn's fit of the flagship's candidates from the ranking's init: the
    per-step losses on the host, the launch counts, the parameters."""
    cfg, lat, img, pool = flagship
    params = ranking.init_rank_params(cfg, len(lat.angles), device)
    kernels.reset_launches()
    with matmul_precision('float32'):
        losses = fn(params, [lat], img[None], [pool],
                    [torch.Generator().manual_seed(cfg.seed + 1)],
                    lat.angles[None], lat.periods[None], n_iters)
    torch.cuda.synchronize()
    return (losses.cpu().double().numpy(),
            {k: v for k, v in kernels.launch_counts().items() if v},
            {k: v.detach().clone() for k, v in params.state_dict().items()})


def traced(fn):
    """fn() under a profiler, and the program's spans it recorded."""
    from torch.profiler import ProfilerActivity, profile
    debug.RECORD.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, list(debug.RECORD.spans)


def steps_holding(spans, name):
    """The step ids of the npp.step spans with a `name` span inside."""
    return sorted({s.step for s in spans if s.name == name})


@pytest.mark.cuda
def test_the_graph_fit_follows_the_eager_loop(card, flagship):
    n = flagship[0].N_iters
    graph, spans = traced(lambda: fit(ranking.fit_candidates_suite,
                                      flagship, n, card))
    eager = fit(eager_fit, flagship, n, card)
    g_loss, e_loss = graph[0], eager[0]
    assert np.all(np.isfinite(g_loss)) and len(g_loss) == n
    first = np.abs(g_loss[:4] - e_loss[:4]) / np.abs(e_loss[:4])
    assert first.max() < 1e-6, first
    gap = np.mean(np.abs(g_loss - e_loss)) / np.mean(np.abs(e_loss))
    assert gap < 1e-4, gap
    assert graph[1] == eager[1]
    assert graph[1]['robust_rho_fwd'] == graph[1]['robust_rho_bwd'] == n
    steps = [s.step for s in spans if s.name == 'npp.step']
    assert steps == list(range(n))
    replays = [s for s in spans if s.name == 'npp.graph.replay']
    assert len(replays) == n - ranking.EAGER_STEPS
    assert steps_holding(spans, 'npp.graph.replay') == \
        list(range(ranking.EAGER_STEPS, n))
    assert steps_holding(spans, 'npp.graph.capture') == [ranking.EAGER_STEPS]
    assert all(spans[s.parent].name == 'npp.step' for s in replays)
    replayed = {s.step for s in replays}
    assert sum(s.syncs for s in spans if s.step in replayed) == 0
    assert sum(s.name == 'npp.h2d' for s in spans) == 1


@pytest.mark.cuda
def test_the_replays_never_sync(card, flagship):
    fit(ranking.fit_candidates_suite, flagship, 12, card)    # warm
    cfg, lat, img, pool = flagship
    params = ranking.init_rank_params(cfg, len(lat.angles), card)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode('error')
    try:
        with matmul_precision('float32'):
            losses = ranking.fit_candidates(
                params, lat, img, pool,
                torch.Generator().manual_seed(cfg.seed + 1), 40)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert np.all(np.isfinite(losses.cpu().numpy()))


@pytest.mark.cuda
def test_the_graph_leaves_only_its_losses(card, flagship):
    """After a first fit (which makes the cached constants, the stream and
    the pool), allocated memory comes back to its level but for the
    losses, and the memory reserved does not grow from fit to fit."""
    cfg, lat, img, pool = flagship
    reserved = []
    for i in range(3):
        params = ranking.init_rank_params(cfg, len(lat.angles), card)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(card)
        with matmul_precision('float32'):
            losses = ranking.fit_candidates(
                params, lat, img, pool,
                torch.Generator().manual_seed(cfg.seed + 1), 60)
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated(card)
        assert all(p.grad is None for p in params.parameters())
        reserved.append(torch.cuda.memory_reserved(card))
        if i:
            assert after - before <= -(-losses.numel() * 4 // 512) * 512
    assert reserved[2] == reserved[1], reserved


@pytest.mark.cuda
def test_pytorch_can_free_the_cublas_workspaces(card):
    """_fit_on_card frees cuBLAS's workspaces through a call private to
    PyTorch, which a later PyTorch may drop: this fails first then."""
    assert callable(getattr(torch._C, '_cuda_clearCublasWorkspaces', None))


@pytest.mark.cuda
def test_the_search_picks_the_same_top3(card, monkeypatch):
    cfg, data = SearchConfig(), synthetic_search_data(0)
    graph = search.run_search(cfg, device=card, data=data, save=False)
    monkeypatch.setattr(ranking, 'fit_candidates_suite', eager_fit)
    eager = search.run_search(cfg, device=card, data=data, save=False)
    for key in ('selected_shifts', 'selected_angles', 'selected_periods'):
        assert graph[key][:3] == eager[key][:3], key
    np.testing.assert_allclose(graph['distances'][:3], eager['distances'][:3],
                               rtol=1e-3)


@pytest.mark.cuda
def test_the_suite_fit_replays_too(card):
    cfg = SearchConfig()
    datas = [synthetic_search_data(s) for s in (0, 1, 2)]
    stats = {}
    _, spans = traced(lambda: search.run_search_suite(
        [cfg] * 3, device=card, datas=datas, save=False, stats=stats))
    assert steps_holding(spans, 'npp.graph.replay') == \
        list(range(ranking.EAGER_STEPS, cfg.N_iters))
    assert np.all(np.isfinite(stats['fit_losses']))


@pytest.mark.cuda
def test_a_short_fit_captures_nothing(card, flagship):
    (graph, counts, state), spans = traced(
        lambda: fit(ranking.fit_candidates_suite, flagship, 3, card))
    eager = fit(eager_fit, flagship, 3, card)
    assert not [s for s in spans if s.name.startswith('npp.graph.')]
    assert [s.step for s in spans if s.name == 'npp.step'] == [0, 1, 2]
    assert np.max(np.abs(graph - eager[0]) / np.abs(eager[0])) < 1e-6
    assert counts == eager[1]
