"""The plain reference (npp_bench/reference/) agrees with the port's fit
step for both configurations, completion and remapping: each cell at a
small size on the CPU, both sides in f32, through the harness's own run
(the program's first block read through its own call, the reference over
the same inputs)."""
import pytest

from small import CELLS, run, with_remapping


@pytest.mark.parametrize('cell', CELLS + ('remapping-flagship',))
def test_reference_follows_the_port(cell, tmp_path):
    out = run(cell, **(with_remapping(tmp_path)
                       if cell.startswith('remapping') else {}))
    n = out['numbers']
    assert out['result']['correct'], n
    assert n['batch_mismatch'] == 0
    # both sides f32 on the CPU: only the order of operations differs
    assert n['pred_gap'] < 1e-5
    assert n['loss_gap'] < 1e-5
    assert n['scale_grad_gap'] < 1e-5
    assert n['change_gap'] < 1e-3
    # the program's own pixel-latent alpha gradient (through the robust
    # loss's f32 spline) keeps about four digits; every other leaf more
    assert n['grad_gap'] < 2e-3
    assert out['diag']['followed'] >= 3
