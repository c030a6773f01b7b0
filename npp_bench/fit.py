"""What the two fit kinds (programs/fit_block.py and
programs/batched_fit_block.py) share: every step of the kinds' contract
(programs/__init__.py) but `build`, which program.py holds for both.

 - make_inputs: the images' arrays (inputs.py), the towers' weights drawn
   on the card from the seed, and the fit's seed;
 - staged: the weights written as the port's documented weight source
   reads them ($NPP_TPU_WEIGHTS_DIR), and the reference's copy moved to the
   host, out of the window's peak;
 - first_block: the first block, driven through the block's own call and
   feed and read by program.Record (on the host);
 - check: with the program freed, the plain reference over the same
   inputs for the steps the first block was read at (reference/fit.py),
   and the CX chain on the inputs of the program's first call of K3,
   compared (check.py);
 - limits: limits/<cell>.json (check.load_limits);
 - work: flops.py::fit_work, from the configuration's published widths;
 - calibrate: one seed's readings of the program, the control and the
   planted faults, which the limits are set from (calibrate.py).
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Optional

from . import check as fit_check
from . import flops, harness, inputs, program

K3_FAULT = 0.01


@dataclass
class FitInputs:
    arrays: list       # one dict of arrays per image
    weights: dict      # {tower: {'conv<i>': (weight OIHW, bias)}}
    base: int          # the fit's seed


def cell_inputs(config: dict, traffic: dict, seed: int, device):
    """(the images' arrays, the towers' weights on `device`, the fit's
    seed) of a run with `seed`."""
    base = inputs.data_seed(seed)
    img = config['image']
    make = inputs.MAKERS[img['maker']]
    kw = {'patch_size': img['patch_size']} if img['maker'] == 'completion' \
        else {}
    arrays = [make(base + off, img['height'], img['width'], **kw)
              for off in traffic['image_seed_offsets']]
    return arrays, inputs.tower_weights(seed, device), base


def make_inputs(config: dict, traffic: dict, seed: int, device) -> FitInputs:
    return FitInputs(*cell_inputs(config, traffic, seed, device))


@contextlib.contextmanager
def staged(inp: FitInputs, directory: str):
    """The weights written to `directory` and named by
    $NPP_TPU_WEIGHTS_DIR while the program runs."""
    inputs.write_weights(inp.weights, directory)
    os.environ['NPP_TPU_WEIGHTS_DIR'] = directory
    os.environ.pop('NPP_TPU_TORCH_WEIGHTS', None)
    # the reference's copy waits on the host, out of the window's peak
    inp.weights = {k: {n: (w.cpu(), b.cpu()) for n, (w, b) in c.items()}
                   for k, c in inp.weights.items()}
    yield


def first_block(fit: program.Fit, config: dict, traffic: dict, device
                ) -> program.Record:
    """The fit's first block, driven through the block's own call and feed
    and read by program.Record (on the host)."""
    rec = program.Record(
        stacked=fit.stacked,
        wait_same=bool(config['config']['use_perceptual_loss']),
        limit=min(program.MAX_FOLLOW, fit.block))
    rec.begin(fit.state)
    with program.recording(rec):
        fit.run_block(fit.state, fit.feed)
    harness.sync(device)
    rec.to_host()
    return rec


def reference_readings(config: dict, arrays, base: int, weights, steps: int,
                       device, control: bool = False,
                       fault: Optional[str] = None) -> list:
    """The reference's Readings of each image over `steps` steps, in f32
    with TF32 off (bf16 autocast for the control)."""
    import torch

    from .reference import fit as reference
    cfg = dict(config['config'], seed=base)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return [reference.reference_steps(config['task'], a, cfg, weights,
                                          steps, device, control, fault)
                for a in arrays]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def cx_reference(cx: Optional[dict], device,
                 control: bool = False) -> Optional[dict]:
    """The reference's chain on the inputs of the program's step-1 call
    of K3 (reference/fit.py::cx_stage): its z and dx, and its z with the
    inputs rounded to TF32 (z_tf32); None without a call."""
    if cx is None or 'dz' not in cx:
        return None
    from .reference import fit as reference
    args = (cx['xn'], cx['yn'], cx['dz'], cx['band_width'], device)
    out = reference.cx_stage(*args, control)
    if not control:
        out['z_tf32'] = reference.cx_stage(*args, tf32_inputs=True)['z']
    return out


def _on(weights: dict, device) -> dict:
    return {k: {n: (w.to(device), b.to(device)) for n, (w, b) in c.items()}
            for k, c in weights.items()}


def check(config: dict, traffic: dict, inp: FitInputs,
          rec: program.Record, device):
    """(the numbers, diagnostics) of the program's first steps against the
    reference's, run once the program is freed."""
    weights = _on(inp.weights, device)
    readings = reference_readings(config, inp.arrays, inp.base, weights,
                                  rec.followed, device)
    prog = fit_check.program_values(rec)
    numbers = fit_check.compare(prog, readings)
    numbers.update(fit_check.cx_numbers(rec.cx, cx_reference(rec.cx, device),
                                        readings))
    diag = {'worst_leaves': fit_check.worst_leaves(prog, readings),
            'followed': rec.followed, 'sources': rec.sources,
            'program_losses': rec.losses,
            'reference_losses': [r.losses for r in readings]}
    return numbers, diag


def limits(bench_dir: str, cell: str) -> dict:
    return fit_check.load_limits(bench_dir, cell)


def work(config: dict, traffic: dict) -> dict:
    return flops.fit_work(config, len(traffic['image_seed_offsets']))


# ---- the readings the limits are set from (calibrate.py) --------------------


def _raw(readings) -> dict:
    """A Readings as JSON (its step-1 output and features left out)."""
    return {k: v for k, v in vars(readings).items()
            if k not in ('pred', 'cx_feats')}


def calibrate(cell: str, config: dict, traffic: dict, seed: int,
              device) -> dict:
    """One seed's readings, each compared with the reference:

     - the program: its first block read as a run reads it (the lower
       readings);
     - the control: the reference computed in bf16 (autocast), the
       precision below the configuration's TF32, put in the program's
       place;
     - a planted fault: the reference with half of its pixel rows and
       patches left out, the means taken over the rest, or with its state
       left unchanged, in the program's place;
     - K3's stage (check.py's cx_* numbers): the control is the chain
       under bf16 autocast on the program's own xn, yn and dz; K3's answer
       altered where it is produced is the program's own step-1 output z,
       or its gradient dx, off by K3_FAULT (what a kernel that returns
       that reads).
    A step that returns its state unchanged reads 1 in change_gap by
    definition."""
    import gc

    import torch
    kind = harness.kind(traffic['entry'])
    inp = make_inputs(config, traffic, seed, device)
    with harness.run_dir() as directory, staged(inp, directory):
        fit, rec, _ = harness.first_block(kind, config, traffic, inp, device)
        del fit
    gc.collect()
    torch.cuda.empty_cache()
    steps = rec.followed
    weights = _on(inp.weights, device)
    ref = reference_readings(config, inp.arrays, inp.base, weights, steps,
                             device)
    prog = fit_check.program_values(rec)
    cx = rec.cx
    cxr = cx_reference(cx, device)
    row = {'cell': cell, 'seed': seed, 'sources': rec.sources,
           'followed': steps, 'program': dict(
               fit_check.compare(prog, ref),
               **fit_check.cx_numbers(cx, cxr, ref)),
           'program_worst': fit_check.worst_leaves(prog, ref),
           'raw': {'reference': [_raw(r) for r in ref],
                   'program': dict(prog, pred=None)}}
    for name, kw in (('control_bf16', {'control': True}),
                     ('fault_half_batch', {'fault': 'half_batch'}),
                     ('fault_frozen', {'fault': 'frozen'})):
        alt = reference_readings(config, inp.arrays, inp.base, weights,
                                 steps, device, **kw)
        vals = fit_check.reading_values(alt)
        row[name] = fit_check.compare(vals, ref)
        row[name + '_worst'] = fit_check.worst_leaves(vals, ref)
        row['raw'][name] = [_raw(r) for r in alt]
        if name == 'control_bf16' and cx is not None:
            ctl = cx_reference(cx, device, control=True)
            feats = [r.cx_feats for r in alt]
            side = {'xn': torch.cat([f[0] for f in feats]),
                    'yn': torch.cat([f[1] for f in feats]),
                    'z': ctl['z'], 'dx': ctl['dx']}
            row[name].update(fit_check.cx_numbers(side, cxr, ref))
    if cx is not None:
        for name, key in (('fault_k3_output', 'z'),
                          ('fault_k3_gradient', 'dx')):
            side = dict(cx, **{key: cx[key] * (1.0 + K3_FAULT)})
            row[name] = fit_check.cx_numbers(side, cxr, ref)
    del weights, ref
    gc.collect()
    torch.cuda.empty_cache()
    return row
