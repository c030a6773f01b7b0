"""The port's spans and host-sync counter (npp_tpu_torch/utils/debug.py) on
the CPU: with no profiler a span is a no-op that records nothing; under
one, a few steps of a tiny fit (one image, and the batched path) record
every phase nested under its step, the same names land in the profiler's
Chrome trace, and PyTorch's sync warnings are counted against the
innermost open span while every other warning passes through. The step
copies to the device exactly the draws of its generators. On the card
(marker `cuda`): a real blocking copy is counted, and the fit's steps
copy their draws without a sync."""
import json
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from npp_tpu_torch import config as TC
from npp_tpu_torch import device as TD
from npp_tpu_torch.models import sampler, trainer
from npp_tpu_torch.models.loaders import TaskData
from npp_tpu_torch.models.pipeline import build_components, make_fit_consts
from npp_tpu_torch.models.trainer import (COMPLETION_TASK, draw_batch,
                                          init_fit_state, make_fit_block,
                                          make_render)
from npp_tpu_torch.nn.embedder import make_task_embedder
from npp_tpu_torch.parallel import batch
from npp_tpu_torch.parallel.batch import (init_batched_state,
                                          make_batched_fit_block,
                                          stack_consts, stack_embedders)
from npp_tpu_torch.utils import debug

CPU = torch.device('cpu')
TINY = dict(netwidth=32, netdepth=6, N_rand=64, patch_num=1,
            num_real_patch_per_sample=2, matmul_precision='float32')
PHASES = ('npp.draw', 'npp.h2d', 'npp.embed', 'npp.mlp', 'npp.loss.pixel',
          'npp.loss.cx', 'npp.backward', 'npp.adam')


@pytest.fixture(autouse=True)
def fresh_record():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    debug.RECORD.clear()
    try:
        yield debug.RECORD
    finally:
        debug.RECORD.clear()
        torch.set_num_threads(n)


def _arrays(h=40, w=48, shift=0):
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    img = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (yy + shift) / 10.0),
                    0.5 + 0.4 * np.cos(2 * np.pi * xx / 12.0),
                    0.5 * np.ones_like(yy)], -1)
    mask = np.ones((h, w, 1))
    mask[15:22, 18:28] = 0
    valid = np.ones((h, w, 1))
    return TaskData(img=img, masked_img=img * mask, mask=mask,
                    valid_mask=valid,
                    i_train=np.stack(np.nonzero(mask[..., 0]), 1),
                    i_val=np.stack(np.nonzero(1 - mask[..., 0]), 1),
                    selected_shifts=[[[12.0, 0.0], [0.0, 10.0]]] * 3,
                    selected_angles=[[90.0, 180.0]] * 3,
                    selected_periods=[[10.0, 12.0]] * 3, patch_size=16)


@pytest.fixture(scope='module')
def parts():
    cfg = TC.replace(TC.CompletionConfig(), **TINY)
    datas = [_arrays(), _arrays(shift=3)]
    return cfg, datas, build_components(cfg, datas[0], CPU, COMPLETION_TASK)


def _fit(parts, entry, block, dev=CPU):
    """(run_block, state, feed) of a tiny fit on `dev` (parts' components
    built there): one image through make_fit_block, or two stacked through
    make_batched_fit_block."""
    cfg, datas, comps = parts
    state = init_fit_state(cfg, comps.model, comps.percep, dev, comps.style)
    if entry == 'single':
        consts = make_fit_consts(cfg, datas[0], 16, dev, COMPLETION_TASK)
        run = make_fit_block(cfg, comps.embedder, consts, comps.percep,
                             comps.contextual, cfg.patch_num, 16, block)
        return run, state, torch.Generator().manual_seed(1)
    emb_b = stack_embedders([make_task_embedder(
        cfg, np.asarray(d.selected_angles), np.asarray(d.selected_periods),
        d.img.shape[:2], torch.Generator().manual_seed(cfg.seed), dev)
        for d in datas])
    consts = stack_consts([make_fit_consts(cfg, d, 16, dev, COMPLETION_TASK)
                           for d in datas])
    run = make_batched_fit_block(cfg, emb_b, consts, comps.percep,
                                 comps.contextual, cfg.patch_num, 16, block,
                                 grid_hw=(40, 48), table=torch.float32)
    return (run, init_batched_state(cfg, state, len(datas)),
            [torch.Generator().manual_seed(1) for _ in datas])


def _staging(monkeypatch):
    """Every copy the fit stages through device.py::to_device_async, as
    (a copy of the host tensor, the result), in call order."""
    seen = []

    def stage(t, dev):
        out = TD.to_device_async(t, dev)
        seen.append((t.clone(), out))
        return out

    for module in (sampler, trainer, batch):
        monkeypatch.setattr(module, 'to_device_async', stage)
    return seen


def _replayed_draws(parts, entry, steps, skip):
    """(fake-patch centre indices, pixel indices) that `steps` steps of
    _fit's block draw after `skip` steps, replayed on the host from
    generators seeded alike: per step, each image's draw_batch in turn."""
    cfg, datas, _ = parts
    n = 1 if entry == 'single' else len(datas)
    samplers = [make_fit_consts(cfg, d, 16, CPU, COMPLETION_TASK)
                for d in datas[:n]]
    gens = [torch.Generator().manual_seed(1) for _ in range(n)]
    pixels = []
    with pytest.MonkeyPatch.context() as mp:
        seen = _staging(mp)
        for _ in range(skip + steps):
            for c, g in zip(samplers, gens):
                _, pix = draw_batch(cfg, g, c.sampler, c.pool_train_n,
                                    cfg.patch_num, 16)
                pixels.append(pix)
    return [t for t, _ in seen][skip * n:], pixels[skip * n:]


def _check_staged(seen, parts, entry, steps, skip=0):
    """The staged copies of `steps` steps after `skip` are the host draws,
    value for value and dtype for dtype, on the fit's device: the pixel
    indices (N_rand of them) and the fake-patch centres, each in the order
    the generators drew them."""
    cfg = parts[0]
    centres, pixels = _replayed_draws(parts, entry, steps, skip)
    for host, out in seen:
        assert out.dtype == host.dtype and out.shape == host.shape
        assert torch.equal(out.cpu(), host)
    got_pix = [h for h, _ in seen if h.numel() == cfg.N_rand]
    got_cent = [h for h, _ in seen if h.numel() != cfg.N_rand]
    assert len(got_pix) == len(pixels) and len(got_cent) == len(centres)
    assert all(torch.equal(a, b) for a, b in zip(got_pix, pixels))
    assert all(torch.equal(a, b) for a, b in zip(got_cent, centres))


def _ancestors(spans, i):
    p = spans[i].parent
    while p >= 0:
        yield spans[p]
        p = spans[p].parent


def test_no_profiler_no_record_function(parts, monkeypatch, fresh_record):
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, 'record_function',
                        lambda name: made.append(name) or real(name))
    run, state, feed = _fit(parts, 'single', 3)
    run(state, feed)
    cfg, _, comps = parts
    make_render(cfg, comps.embedder)(state.params, 8, 8)
    timer = debug.PhaseTimer()
    with timer.phase('npp.search.detect'):
        pass
    assert made == []
    assert fresh_record.spans == [] and fresh_record.steps == 0
    assert debug.span('npp.step', 0) is debug.span('npp.draw')
    assert 'npp.search.detect' in timer.phases


@pytest.mark.parametrize('entry', ['single', 'batched'])
def test_profiled_steps_nest_under_their_step(parts, entry, tmp_path,
                                              fresh_record):
    run, state, feed = _fit(parts, entry, 8)
    first = state.step
    with debug.trace(str(tmp_path)):
        run(state, feed)
    spans = fresh_record.spans
    steps = [s for s in spans if s.name == 'npp.step']
    assert fresh_record.steps == 8
    assert [s.step for s in steps] == list(range(first, first + 8))
    blocks = [s for s in spans if s.name == 'npp.block']
    assert len(blocks) == 1 and blocks[0].parent == -1
    assert [s.name for s in spans if s.parent == 0][0] == 'npp.table'
    for i, s in enumerate(spans):
        assert s.start <= s.end
        if s.name in PHASES:
            up = list(_ancestors(spans, i))
            owner = [a for a in up if a.name == 'npp.step']
            assert len(owner) == 1 and owner[0].step == s.step, s
            assert s.start >= owner[0].start and s.end <= owner[0].end
    names = {s.name for s in spans}
    assert set(PHASES) <= names
    draws = [s for s in spans if s.name == 'npp.draw']
    assert len(draws) == 8 * (1 if entry == 'single' else 2)
    # each draw copies its fake-patch centres to the device inside it
    for i, s in enumerate(spans):
        if s.name == 'npp.draw':
            assert any(c.parent == i and c.name == 'npp.h2d' for c in spans)
    with open(tmp_path / 'trace.json') as f:
        events = json.load(f)['traceEvents']
    annotated = {e['name'] for e in events
                 if e.get('cat') == 'user_annotation'
                 and e['name'].startswith('npp.')}
    assert annotated == names
    with open(tmp_path / 'spans.json') as f:
        saved = json.load(f)
    assert saved['steps'] == 8 and len(saved['spans']) == len(spans)


@pytest.mark.parametrize('entry', ['single', 'batched'])
def test_the_step_copies_its_generators_draws(parts, entry, monkeypatch):
    run, state, feed = _fit(parts, entry, 3)
    seen = _staging(monkeypatch)
    run(state, feed)
    assert all(out.device == CPU for _, out in seen)
    _check_staged(seen, parts, entry, 3)


def test_record_kept_until_the_next_profiled_run(parts, fresh_record):
    run, state, feed = _fit(parts, 'single', 2)
    with profile(activities=[ProfilerActivity.CPU]):
        run(state, feed)
    run(state, feed)                   # no profiler: the record stays
    assert fresh_record.steps == 2
    with profile(activities=[ProfilerActivity.CPU]):
        run(state, feed)
        run(state, feed)               # one profiled run: both blocks
    assert fresh_record.steps == 4
    run(state, feed)
    with profile(activities=[ProfilerActivity.CPU]):
        run(state, feed)               # a new profiled run starts anew
    assert fresh_record.steps == 2


def test_sync_warnings_counted_others_pass(monkeypatch, recwarn,
                                           fresh_record):
    modes = ['default']
    monkeypatch.setattr(debug, '_cuda_ready', lambda: True)
    monkeypatch.setattr(torch.cuda, 'get_sync_debug_mode',
                        lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, 'set_sync_debug_mode', modes.append)
    shown, filters = warnings.showwarning, list(warnings.filters)
    with profile(activities=[ProfilerActivity.CPU]):
        with debug.span('npp.block'):
            assert modes[-1] == 'warn'
            with debug.span('npp.step', 7):
                with debug.span('npp.draw'):
                    warnings.warn(debug.SYNC_WARNING +
                                  ' (Triggered internally at Copy.cu)')
                    warnings.warn('an unrelated warning', RuntimeWarning)
                warnings.warn(debug.SYNC_WARNING)
    assert modes == ['default', 'warn', 'default']
    assert warnings.showwarning is shown
    assert warnings.filters == filters
    counts = {s.name: s.syncs for s in fresh_record.spans}
    assert counts == {'npp.block': 0, 'npp.step': 1, 'npp.draw': 1}
    assert fresh_record.spans[2].step == 7
    seen = [str(w.message) for w in recwarn]
    assert 'an unrelated warning' in seen
    assert not any(debug.SYNC_WARNING in m for m in seen)
    # no profiler: nothing is switched on and a sync warning is shown
    with pytest.warns(UserWarning, match=debug.SYNC_WARNING):
        with debug.span('npp.block'):
            warnings.warn(debug.SYNC_WARNING)
    assert modes == ['default', 'warn', 'default']


def test_phase_timer_phases_are_spans(fresh_record):
    timer = debug.PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.phase('npp.search.rank'):
            with timer.phase('npp.search.rank_fit'):
                torch.ones(3).sum()
    spans = fresh_record.spans
    assert [(s.name, s.parent) for s in spans] == [
        ('npp.search.rank', -1), ('npp.search.rank_fit', 0)]
    assert timer.phases['npp.search.rank'] >= \
        timer.phases['npp.search.rank_fit'] > 0


def test_kernel_times_leave_out_annotations():
    from types import SimpleNamespace as NS
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [NS(key='gemm', self_device_time_total=2000.0, count=2,
                 device_type=cuda, is_user_annotation=False),
              NS(key='npp.step', self_device_time_total=9000.0, count=1,
                 device_type=cuda, is_user_annotation=True),
              NS(key='aten::add', self_device_time_total=0.0, count=5,
                 device_type=cpu, is_user_annotation=False)]
    prof = NS(key_averages=lambda: events)
    assert debug.kernel_times(prof) == {'gemm': [2.0, 2]}


@pytest.mark.cuda
def test_a_blocking_copy_counts_on_the_card(fresh_record):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    dev = torch.device('cuda')
    torch.zeros(1, device=dev)
    before = torch.cuda.get_sync_debug_mode()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with debug.span('npp.block'):
            with debug.span('npp.h2d'):
                torch.arange(5).to(dev)
            y = torch.ones(4, device=dev) * 2
            with debug.span('npp.draw'):
                y.sum().item()
                torch.arange(5).to(dev, non_blocking=True)
    assert torch.cuda.get_sync_debug_mode() == before
    counts = {s.name: s.syncs for s in fresh_record.spans}
    assert counts == {'npp.block': 0, 'npp.h2d': 1, 'npp.draw': 1}


@pytest.mark.cuda
@pytest.mark.parametrize('entry', ['single', 'batched'])
def test_the_fit_step_never_syncs_on_the_card(entry, tmp_path, monkeypatch,
                                              fresh_record):
    """After a warm-up block (kernel builds, the constants' one copy), the
    fit's blocks run under sync debug mode 'error' without raising, the
    spans count no sync in any step, and the pinned non-blocking copies
    hold the host draws once the card has caught up."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    dev = torch.device('cuda')
    cfg = TC.replace(TC.CompletionConfig(), **TINY)
    datas = [_arrays(), _arrays(shift=3)]
    parts = (cfg, datas, build_components(cfg, datas[0], dev,
                                          COMPLETION_TASK))
    run, state, feed = _fit(parts, entry, 4, dev)
    run(state, feed)
    torch.cuda.synchronize()
    seen = _staging(monkeypatch)
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode('error')
    try:
        run(state, feed)
    finally:
        torch.cuda.set_sync_debug_mode(before)
    torch.cuda.synchronize()
    assert seen and all(out.device.type == 'cuda' for _, out in seen)
    _check_staged(seen, parts, entry, 4, skip=4)
    with debug.trace(str(tmp_path)):
        run(state, feed)
    steps = [i for i, s in enumerate(fresh_record.spans)
             if s.name == 'npp.step']
    assert len(steps) == 4
    in_steps = [s for i, s in enumerate(fresh_record.spans)
                if s.name == 'npp.step' or any(
                    a.name == 'npp.step'
                    for a in _ancestors(fresh_record.spans, i))]
    assert sum(s.syncs for s in in_steps) == 0
    assert fresh_record.syncs == 0
