"""The comparison that decides `correct`: the program's first steps, read
through its own block, against the plain reference's (reference/fit.py)
on the same inputs.

Every number is computed in every run; a cell compares those that its
limits/<cell>.json gives a limit, and reports the rest:
 - `batch_mismatch`: steps whose branch (val / train / same) differs
   between the two sides, which draw from generators seeded alike; any is
   a fault of the sampled batch (exact: limit 0);
 - `pred_gap`: the MLP's output for step 1's rows (every image), the norm
   of the two sides' difference over the reference's norm (embedding, K1,
   the GEMMs, K2);
 - `scale_grad_gap`: the largest relative gap of the first gradient of
   the scale latents of the pixel and style losses, the adaptive losses
   every step evaluates: each is a smooth mean over the loss's rows or
   samples, steady from seed to seed and moved by any change of what the
   mean is taken over;
 - `loss_gap`: the largest relative gap of a step's loss over the steps
   followed (B stacked images: the sum of the images' losses);
 - `grad_gap`: over the leaves of every image, the largest gap between
   the norms of the first gradient (Adam's first moment after one step
   over 1 - beta1) on the two sides, over the reference's norm of that
   leaf or of the image's median leaf, whichever is larger;
 - `change_gap`: the same for the norm of each leaf's change after the
   steps followed, over the leaves whose largest reference gradient is at
   least a thousandth of the median leaf's (a leaf below that moves under
   Adam by round-off alone; in these fits, the LPIPS latents before a
   'same' batch);
 - K3's stage in step 1, the CX loss's similarity chain (kernels/
   cx_chain.py): the reference's plain chain (reference/fit.py::cx_stage,
   float64) is run on the xn, yn that the program handed its kernel and
   on the upstream gradient dz it handed back, and judges the kernel's
   output; the start of that stage is judged by itself:
   - `cx_feat_gap`: the larger of the norms of the differences of the
     program's xn and yn from the reference's own (VGG19 relu3_4 of its
     own step 1, shifted and normalised) over the reference's norm;
   - `cx_z_gap`: K3's output z (N, Q) against the chain's, the same way,
     over the columns whose answer rounding the chain's inputs to TF32
     moves by at most CX_TIE of the column's scale (the share kept is
     reported as `cx_z_kept`). The relative distance divides by each
     row's nearest distance plus 1e-5, and rows of features that the
     real patch's mask zeroes on both sides are near-duplicates whose
     nearest distance is rounding: there TF32 inputs alone move the
     answer by up to a fifth, the bf16 control by more, and which of two
     near-equal rows takes a column turns on rounding;
 - reported only: loss1_gap (step 1's loss), each loss term's largest
   relative gap, cx_z_kept, and cx_dx_gap (K3's gradient in xn over all
   its rows, which the near-duplicate rows and ties leave undetermined
   at TF32: it is not compared).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

BETA1 = 0.9
NUMBERS = ('batch_mismatch', 'pred_gap', 'scale_grad_gap', 'loss_gap',
           'grad_gap', 'change_gap', 'cx_feat_gap', 'cx_z_gap', 'loss1_gap',
           'pixel_gap', 'contextual_gap', 'perceptual_gap', 'style_gap',
           'cx_z_kept', 'cx_dx_gap')
CX_NUMBERS = ('cx_feat_gap', 'cx_z_gap', 'cx_z_kept', 'cx_dx_gap')
CX_TIE = 1e-3


def scale_leaf(name: str) -> bool:
    """The scale latents of the adaptive losses that every step evaluates:
    the pixel loss's and the style loss's (LPIPS runs on 'same' batches
    only)."""
    return name.endswith('latent_scale') and \
        name.startswith(('adaptive_pix.', 'adaptive_style.'))



def load_limits(bench_dir: str, cell: str) -> Dict[str, float]:
    """The cell's compared numbers and their limits; a number without a
    limit is reported and not compared."""
    with open(os.path.join(bench_dir, 'limits', f'{cell}.json')) as f:
        limits = json.load(f)['limits']
    unknown = sorted(set(limits) - set(NUMBERS))
    if unknown or 'batch_mismatch' not in limits:
        raise KeyError(f'limits/{cell}.json: unknown {unknown} or no '
                       'batch_mismatch')
    return {n: float(limits[n]) for n in NUMBERS if n in limits}


def _norm(t) -> float:
    return float(np.linalg.norm(np.asarray(t, np.float64).ravel()))


def _gaps(prog: Dict[str, float], ref: Dict[str, float],
          leaves: Sequence[str]) -> Dict[str, float]:
    med = float(np.median([ref[k] for k in leaves])) if leaves else 0.0
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in leaves}


def _worst(prog, ref, leaves) -> float:
    return max(_gaps(prog, ref, leaves).values(), default=0.0)


def worst_leaves(prog: dict, readings: Sequence) -> Dict[str, list]:
    """Diagnostics: for grad_gap and change_gap, the three leaves that
    read most, as [image, leaf, gap, program norm, reference norm]."""
    out = {'grad': [], 'change': []}
    for j, ref in enumerate(readings):
        med_g = float(np.median(list(ref.grad_max.values())))
        moving = [k for k, g in ref.grad_max.items() if g >= 1e-3 * med_g]
        for name, p, r, leaves in (
                ('grad', prog['grads'][j], ref.first_grad, list(ref.first_grad)),
                ('change', prog['changes'][j], ref.change, moving)):
            out[name] += [[j, k, g, p[k], r[k]]
                          for k, g in _gaps(p, r, leaves).items()]
    return {k: sorted(v, key=lambda x: -x[2])[:3] for k, v in out.items()}


def program_values(record) -> dict:
    """The program's Record as the numbers compare it: each step's loss,
    its branches, and per image each leaf's first-gradient and change
    norms."""
    images = len(next(iter(record.after.values())))
    pred = record.pred if record.stacked else record.pred[None]
    return {
        'losses': record.losses, 'sources': record.sources,
        'terms': record.terms, 'pred': pred,
        'grads': [{k: _norm(v[j].numpy()) / (1.0 - BETA1)
                   for k, v in record.first_moment.items()}
                  for j in range(images)],
        'changes': [{k: _norm(record.after[k][j].numpy() -
                              record.start[k][j].numpy())
                     for k in record.after} for j in range(images)]}


def reading_values(readings: Sequence) -> dict:
    """Reference readings put in the program's place (the control, a
    planted fault), as program_values gives the program's."""
    n = len(readings[0].losses)
    return {'losses': [sum(r.losses[k] for r in readings) for k in range(n)],
            'sources': list(readings[0].sources),
            'terms': _mean_terms(readings),
            'pred': _stack_pred(readings),
            'grads': [r.first_grad for r in readings],
            'changes': [r.change for r in readings]}


def _mean_terms(readings) -> List[Dict[str, float]]:
    """Each step's loss terms, averaged over the images (as the port's
    metrics average them)."""
    return [{k: float(np.mean([r.terms[s][k] for r in readings]))
             for k in readings[0].terms[s]}
            for s in range(len(readings[0].terms))]


def _stack_pred(readings):
    shapes = {tuple(r.pred.shape) for r in readings}
    return np.stack([r.pred.numpy() for r in readings]) \
        if len(shapes) == 1 else None


def _rel(p: float, q: float) -> float:
    return abs(p - q) / max(abs(q), 1e-30)


def compare(prog: dict, readings: Sequence) -> Dict[str, float]:
    """The numbers of the program's values (program_values) against the
    reference's Readings (one per image), over the steps the program was
    read at."""
    n = len(prog['losses'])
    ref_sources = list(readings[0].sources[:n])
    mismatch = sum(int(a != b) for a, b in zip(prog['sources'], ref_sources))
    mismatch += sum(int(r.sources[:n] != ref_sources) for r in readings[1:])
    ref_loss = [sum(r.losses[k] for r in readings) for k in range(n)]
    gaps = [_rel(p, q) for p, q in zip(prog['losses'], ref_loss)]
    out = {'batch_mismatch': float(mismatch), 'loss1_gap': gaps[0],
           'loss_gap': max(gaps), 'grad_gap': 0.0, 'change_gap': 0.0,
           'scale_grad_gap': 0.0}
    ref_pred = _stack_pred(readings)
    p_pred = prog['pred']
    p_pred = None if p_pred is None else np.asarray(p_pred, np.float64)
    out['pred_gap'] = float('nan') if p_pred is None or \
        p_pred.shape != ref_pred.shape else \
        float(np.linalg.norm(p_pred - ref_pred) / np.linalg.norm(ref_pred))
    ref_terms = _mean_terms(readings)
    for t in ('pixel', 'contextual', 'perceptual', 'style'):
        pairs = [(a[t], b[t]) for a, b in zip(prog['terms'], ref_terms)
                 if t in a and t in b and b[t] != 0.0]
        out[f'{t}_gap'] = max((_rel(a, b) for a, b in pairs), default=0.0)
    for j, ref in enumerate(readings):
        med_g = float(np.median(list(ref.grad_max.values())))
        moving = [k for k, g in ref.grad_max.items() if g >= 1e-3 * med_g]
        for name, p, r, leaves in (
                ('grad_gap', prog['grads'][j], ref.first_grad,
                 list(ref.first_grad)),
                ('change_gap', prog['changes'][j], ref.change, moving)):
            out[name] = max(out[name], _worst(p, r, leaves))
        out['scale_grad_gap'] = max(
            [out['scale_grad_gap']] +
            [_rel(prog['grads'][j][k], ref.first_grad[k])
             for k in ref.first_grad if scale_leaf(k)])
    return out


def _rel_norm(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float('nan')
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def cx_numbers(side: Optional[dict], ref: Optional[dict],
               readings: Sequence) -> Dict[str, float]:
    """K3's stage numbers of `side` ({'xn', 'yn', 'z', 'dx'}: the program's
    step-1 call of its kernel, or what is put in its place) against the
    chain on the same inputs (fit.py::cx_reference) and the reference's
    own features (Readings.cx_feats, one per image, in the program's
    order of images)."""
    if side is None or 'dx' not in side or ref is None or \
            any(r.cx_feats is None for r in readings):
        return {k: float('nan') for k in CX_NUMBERS}
    xr = np.concatenate([r.cx_feats[0].numpy() for r in readings])
    yr = np.concatenate([r.cx_feats[1].numpy() for r in readings])
    z, rz = np.asarray(side['z'], np.float64), np.asarray(ref['z'])
    scale = np.maximum(np.abs(rz), np.median(np.abs(rz)))
    keep = np.abs(np.asarray(ref['z_tf32']) - rz) <= CX_TIE * scale
    return {'cx_feat_gap': max(_rel_norm(side['xn'], xr),
                               _rel_norm(side['yn'], yr)),
            'cx_z_gap': _rel_norm(z[keep], rz[keep]) if keep.any()
            else float('nan'),
            'cx_z_kept': float(keep.mean()),
            'cx_dx_gap': _rel_norm(side['dx'], ref['dx'])}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)


def lines(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f'{k} {numbers[k]!r} limit {limits[k]!r}' for k in limits]
