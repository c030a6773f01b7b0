"""The readers of the program's span record (metrics/host_syncs_per_step,
host_wait_share, sampler_host_share) on a hand-built record: the value
each should give, None without a record, and shares of at most 100."""
import pytest

from npp_bench import harness

READERS = ('host_syncs_per_step', 'host_wait_share', 'sampler_host_share')


def _record(debug):
    """One block of 10 s holding two steps: step 0 draws (3 s, of which a
    1-s copy) then copies (2 s); step 1 draws (1 s, no copy). 7 syncs, 2 in
    step 0's copy. A copy outside any block does not count."""
    S = debug.Span
    rec = debug.SpanRecord()
    rec.spans = [
        S('npp.block', 0.0, 10.0),
        S('npp.step', 0.0, 6.0, parent=0, step=0, syncs=1),
        S('npp.draw', 0.0, 3.0, parent=1, step=0),
        S('npp.h2d', 1.0, 2.0, parent=2, step=0, syncs=1),
        S('npp.h2d', 3.0, 5.0, parent=1, step=0, syncs=2),
        S('npp.step', 6.0, 10.0, parent=0, step=1),
        S('npp.draw', 6.0, 7.0, parent=5, step=1),
        S('npp.loss.cx', 7.0, 9.0, parent=5, step=1, syncs=3),
        S('npp.h2d', 20.0, 30.0),
    ]
    return rec


@pytest.fixture
def debug(monkeypatch):
    from npp_tpu_torch.utils import debug
    monkeypatch.setattr(debug, 'RECORD', debug.SpanRecord())
    return debug


def test_readers_on_a_hand_built_record(debug, monkeypatch):
    monkeypatch.setattr(debug, 'RECORD', _record(debug))
    read = {n: harness.reader(n) for n in READERS}
    assert read['host_syncs_per_step'](None) == pytest.approx(7 / 2)
    assert read['host_wait_share'](None) == pytest.approx(100 * 3 / 10)
    assert read['sampler_host_share'](None) == pytest.approx(
        100 * (2 + 1) / 10)


@pytest.mark.parametrize('name', READERS)
def test_no_record_reads_none(debug, monkeypatch, name):
    assert harness.reader(name)(None) is None
    monkeypatch.delattr(debug, 'RECORD')      # a program without spans
    assert harness.reader(name)(None) is None


@pytest.mark.parametrize('name', ['host_wait_share', 'sampler_host_share'])
def test_shares_stay_within_the_blocks(debug, monkeypatch, name):
    """Copies and draws that fill their block whole, nested in each other
    and outside it, read at most 100."""
    S = debug.Span
    rec = debug.SpanRecord()
    rec.spans = [S('npp.block', 0.0, 4.0),
                 S('npp.step', 0.0, 4.0, parent=0, step=0),
                 S('npp.draw', 0.0, 4.0, parent=1, step=0),
                 S('npp.draw', 0.0, 4.0, parent=2, step=0),
                 S('npp.h2d', 0.0, 4.0, parent=1, step=0),
                 S('npp.h2d', 0.0, 4.0, parent=4, step=0),
                 S('npp.draw', 5.0, 99.0), S('npp.h2d', 5.0, 99.0),
                 S('npp.block', 5.0)]                  # still open
    monkeypatch.setattr(debug, 'RECORD', rec)
    assert 0 <= harness.reader(name)(None) <= 100
