"""The search's spans (npp_tpu_torch/utils/debug.py) on the CPU: a tiny
run_search under a profiler records one npp.block holding the search's
phases, N_iters npp.step spans in the ranking's fit with the step's draw
(its copy inside), render, pixel loss, backward and Adam, and the eval's
render, LPIPS and CX; the same names land in the Chrome trace. Tracing
changes no distance, bit for bit. run_search_suite opens its block too.
Both entries fill the stats keys that their readers read."""
import json

import numpy as np
import pytest
import torch

from npp_tpu_torch.config import SearchConfig, replace
from npp_tpu_torch.losses.contextual import ContextualLoss
from npp_tpu_torch.losses.lpips import LPIPS
from npp_tpu_torch.proposal import search
from npp_tpu_torch.utils import debug
from npp_tpu_torch.utils.synthetic import synthetic_search_data
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

CPU = torch.device('cpu')
TINY = dict(netdepth=2, netwidth=16, N_rand=64, N_iters=4,
            matmul_precision='float32')
PHASES = ('npp.search.detect', 'npp.search.rank', 'npp.search.artefacts')
STEP = ('npp.draw', 'npp.mlp', 'npp.loss.pixel', 'npp.backward', 'npp.adam')
EVAL = ('npp.search.eval.render', 'npp.search.eval.lpips',
        'npp.search.eval.cx')


@pytest.fixture(scope='module')
def towers():
    return LPIPS(CPU), ContextualLoss(CPU)


@pytest.fixture(autouse=True)
def fresh_record():
    debug.RECORD.clear()
    try:
        yield debug.RECORD
    finally:
        debug.RECORD.clear()


def _search(towers, seed=1, size=(64, 96)):
    cfg = replace(SearchConfig(), **TINY)
    return search.run_search(cfg, *towers, device=CPU,
                             data=synthetic_search_data(seed, *size),
                             save=False)


def _named(spans, name):
    return [i for i, s in enumerate(spans) if s.name == name]


def _parent(spans, i):
    return spans[spans[i].parent].name if spans[i].parent >= 0 else None


def test_search_spans_nest_and_change_nothing(towers, tmp_path,
                                             fresh_record):
    plain = _search(towers)
    assert fresh_record.spans == []
    with debug.trace(str(tmp_path)):
        traced = _search(towers)
    for key in ('distances', 'distances_gate', 'selected_angles',
                'selected_periods'):
        assert traced[key] == plain[key], key
    assert traced['rank_candidates'] == plain['rank_candidates']

    spans = fresh_record.spans
    assert all(s.start <= s.end for s in spans)
    blocks = _named(spans, 'npp.block')
    assert blocks == [0] and spans[0].parent == -1
    assert [s.name for s in spans if s.parent == 0] == list(PHASES)
    fit = _named(spans, 'npp.search.rank_fit')
    ev = _named(spans, 'npp.search.rank_eval')
    assert len(fit) == len(ev) == 1
    assert _parent(spans, fit[0]) == _parent(spans, ev[0]) == \
        'npp.search.rank'

    steps = _named(spans, 'npp.step')
    assert [spans[i].step for i in steps] == list(range(TINY['N_iters']))
    assert all(spans[i].parent == fit[0] for i in steps)
    for name in STEP:
        found = _named(spans, name)
        assert len(found) == TINY['N_iters'], name
        assert all(spans[spans[i].parent].name == 'npp.step' for i in found)
        assert [spans[i].step for i in found] == list(range(TINY['N_iters']))
    copies = _named(spans, 'npp.h2d')
    assert len(copies) == TINY['N_iters']
    assert all(_parent(spans, i) == 'npp.draw' for i in copies)
    for name in EVAL:
        found = _named(spans, name)
        assert len(found) == 1 and spans[found[0]].parent == ev[0], name

    with open(tmp_path / 'trace.json') as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert {'npp.block', 'npp.step', 'npp.h2d', *STEP, *EVAL} <= names
    with open(tmp_path / 'spans.json') as f:
        assert json.load(f)['steps'] == TINY['N_iters']


def test_search_suite_opens_a_block(towers, tmp_path, fresh_record):
    cfg = replace(SearchConfig(), **dict(TINY, N_iters=2))
    datas = [synthetic_search_data(s, 64, 96) for s in (1, 2)]
    with debug.trace(str(tmp_path)):
        search.run_search_suite([cfg, cfg], *towers, device=CPU,
                                datas=datas, save=False)
    spans = fresh_record.spans
    assert _named(spans, 'npp.block') == [0]
    assert [s.name for s in spans if s.parent == 0] == list(PHASES)
    steps = _named(spans, 'npp.step')
    assert [spans[i].step for i in steps] == [0, 1]
    assert len(_named(spans, 'npp.search.eval.cx')) == 2
    assert np.isfinite([s.end for s in spans]).all()


FIT_KEYS = ('fit_s', 'fit_ms_per_step', 'eval_s')
EVAL_SPLIT = ('eval_render_s', 'eval_lpips_s', 'eval_cx_s')
WALLS = ('detect_s', 'rank_s', 'artefacts_s', 'total_s')


@pytest.mark.parametrize('entry', ['one image', 'suite of two'])
def test_search_stats_hold_every_key_a_reader_reads(towers, entry):
    """The stats a search fills, as the benchmark's search program,
    chip_smoke.py and scripts/torch_run_suite.py read them: the fit's and
    eval's walls and per-step losses, the phases' walls, and for one image
    the eval's split with its CX sizes and crop."""
    cfg = replace(SearchConfig(), **TINY)
    stats = {}
    if entry == 'one image':
        search.run_search(cfg, *towers, device=CPU,
                          data=synthetic_search_data(1, 64, 96), save=False,
                          stats=stats)
    else:
        search.run_search_suite([cfg, cfg], *towers, device=CPU,
                                datas=[synthetic_search_data(s, 64, 96)
                                       for s in (1, 2)],
                                save=False, stats=stats)
    assert stats['fit_losses'].shape == (TINY['N_iters'],)
    assert np.isfinite(stats['fit_losses']).all()
    split = EVAL_SPLIT if entry == 'one image' else ()
    for key in FIT_KEYS + split + WALLS:
        assert isinstance(stats[key], float) and stats[key] >= 0.0, key
    assert stats['total_s'] == pytest.approx(
        stats['detect_s'] + stats['rank_s'] + stats['artefacts_s'])
    assert stats['fit_ms_per_step'] == pytest.approx(
        1e3 * stats['fit_s'] / TINY['N_iters'])
    if entry == 'one image':
        ch, cw = stats['crop']
        assert stats['cx_positions'] == (ch // 4) * (cw // 4) > 0
        assert stats['cx_group'] >= 1
