"""The check fails what it must fail, at a small size on the CPU, under
each cell's own limits:

 - the control: the reference computed in bf16 (autocast), the precision
   below the configurations' TF32, put in the program's place;
 - a run of the harness (past its look for a card) with the port broken
   underneath, once for each fault a one-card fit can have: a step that
   returns its state unchanged; half of the batch left out, the mean taken
   over the rest; an answer altered where it is produced: the MLP's
   output, or K3's output (the CX chain's column max).
   (A cell on one card has no exchange between cards to leave out.)

The readings on the card at the cells' own sizes, which the limits were
set from, come from npp_bench/calibrate.py (PERF.md)."""
import pytest
import torch

from small import CELLS, overrides, run, with_remapping

ALL = CELLS + ('remapping-flagship',)


def where(cell, tmp_path) -> dict:
    """The benchmark a cell is read from: the repository's, or for the
    remapping cell a copy that lists it."""
    from npp_bench import harness
    return with_remapping(tmp_path) if cell.startswith('remapping') else \
        {'bench_dir': harness.BENCH, 'root': harness.ROOT}


@pytest.mark.parametrize('cell', ALL)
def test_control_is_not_correct(cell, tmp_path):
    from npp_bench import check, harness
    at = where(cell, tmp_path)
    spec = harness.cell_spec(harness.load_benchmark(at['root']), cell,
                             at['root'], at['bench_dir'])
    config, traffic = harness.apply_overrides(spec.config, spec.traffic,
                                              overrides(cell))
    arrays, weights, base = harness.cell_inputs(config, traffic, 11,
                                                torch.device('cpu'))
    ref = harness.reference_readings(config, arrays, base, weights, 3, 'cpu')
    ctl = harness.reference_readings(config, arrays, base, weights, 3, 'cpu',
                                     control=True)
    numbers = check.compare(check.reading_values(ctl), ref)
    limits = check.load_limits(at['bench_dir'], cell)
    assert not check.verdict(numbers, limits)
    assert numbers['pred_gap'] > limits['pred_gap']


def _frozen(monkeypatch):
    """fit_step draws and scores its batch and changes nothing."""
    from npp_tpu_torch.models import trainer
    from npp_tpu_torch.parallel import batch

    def step(state, loss_fn, embedder, consts, gen, schedule):
        with torch.no_grad():
            loss, metrics = loss_fn(state.params, embedder, consts, gen)
        state.step += 1
        metrics['loss'] = loss.detach()
        return metrics

    monkeypatch.setattr(trainer, 'fit_step', step)
    monkeypatch.setattr(batch, 'fit_step', step)


def _half_batch(monkeypatch):
    """The pixel rows' second half repeats the first: the mean is taken
    over half of the batch."""
    from npp_tpu_torch.models import trainer
    from npp_tpu_torch.parallel import batch
    inner = trainer.draw_batch

    def draw(*args, **kw):
        patches, idx = inner(*args, **kw)
        half = idx.shape[0] // 2
        return patches, torch.cat([idx[:half], idx[:idx.shape[0] - half]])

    monkeypatch.setattr(trainer, 'draw_batch', draw)
    monkeypatch.setattr(batch, 'draw_batch', draw)


def _altered(monkeypatch):
    """The MLP's output is off by 1% where it is produced."""
    from npp_tpu_torch.nn import mlp
    inner = mlp.NPPNet.forward

    def forward(self, x):
        return inner(self, x) * 1.01

    monkeypatch.setattr(mlp.NPPNet, 'forward', forward)


def _k3_output_altered(monkeypatch):
    """K3's output z is off by 1% where it is produced."""
    from npp_tpu_torch.losses import contextual
    inner = contextual.cx_colmax

    def cx_colmax(xn, yn, band_width, feat_valid=None):
        return inner(xn, yn, band_width, feat_valid) * 1.01

    monkeypatch.setattr(contextual, 'cx_colmax', cx_colmax)


@pytest.mark.parametrize('fault', [_frozen, _half_batch, _altered,
                                   _k3_output_altered],
                         ids=['state_unchanged', 'half_batch',
                              'answer_altered', 'k3_output_altered'])
@pytest.mark.parametrize('cell', ALL)
def test_fault_is_not_correct(cell, fault, monkeypatch, tmp_path):
    at = where(cell, tmp_path)
    fault(monkeypatch)
    out = run(cell, **at)
    assert out['result']['correct'] is False
    assert any(out['numbers'][k] > v for k, v in out['limits'].items())
