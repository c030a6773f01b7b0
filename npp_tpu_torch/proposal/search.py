"""Periodicity proposal orchestrator (reference: NPP_proposal/search.py:28-285),
a port of `npp_tpu/proposal/search.py::run_search`: detect candidate
periodicities, rank them by light-model fits, and build the odgt record
(and, with save=True, the PNGs and lattice drawings) that the task
pipelines read.

Detection runs on the host with the OpenCV-free primitives of
`proposal/cv.py`, its loss grid on the device through torch.fft; the
ranking's fit and eval run on the device. `run_search_suite` searches a
suite of images with one lockstep ranking fit over (images x candidates)
(ranking.py::rank_proposals_suite).

Each search is one span npp.block (utils/debug.py) holding its phases,
npp.search.{detect,rank,artefacts}; under a profiler, the ranking's steps
and eval record their own spans inside it (ranking.py).
"""
from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..losses.contextual import ContextualLoss
from ..losses.lpips import LPIPS
from ..parallel.mesh import Mesh
from ..utils.debug import PhaseTimer, span
from ..utils.io import read_example_dir, write_gray, write_odgt, write_rgb
from ..utils.visualizer import GridProgram, mask2ltrb
from .pseudo_mask import build_pseudo_split
from .ranking import combine_scores, rank_proposals, rank_proposals_suite
from .search_engine import search_periodicity_by_feat

PHASES = ('detect', 'rank', 'artefacts')   # the spans npp.search.<phase>


def _prepare_search(cfg, data: dict, device: torch.device) -> dict:
    """Host phase of one search: tight-canvas pad, candidate detection
    (its loss grid on `device`) and the pseudo-split. `data` holds the
    example's arrays as utils/io.py::read_example_dir returns them."""
    name = cfg.datadir.rstrip('/').split('/')[-1] or 'example'
    masked_img = data['masked_img']
    unknown_mask = data['unknown_mask']
    valid_mask = data['valid_mask']

    # detection and ranking run on the canvas_multiple canvas (npp_tpu's
    # suite-wide canvas_override pad changes no distance and is not done)
    oh, ow = masked_img.shape[:2]
    m = getattr(cfg, 'canvas_multiple', 0)
    dh, dw = (-(-oh // m) * m, -(-ow // m) * m) if m else (oh, ow)
    if (dh, dw) != (oh, ow):
        pad3 = ((0, dh - oh), (0, dw - ow), (0, 0))
        masked_img = np.pad(masked_img, pad3)
        unknown_mask = np.pad(unknown_mask, pad3)
        valid_mask = np.pad(valid_mask, pad3)

    # candidate detection (reference: loaders.py:28-32)
    all_angles, all_periods, all_shifts = search_periodicity_by_feat(
        np.uint8(masked_img * 255),
        np.uint8(valid_mask * unknown_mask)[..., 0],
        repeat_range=cfg.search_range, edge_searching=cfg.edge_searching,
        gray_only=cfg.gray_only, device=device)
    if not all_angles:
        raise RuntimeError(f'no periodicity candidates found for {name}')

    # pseudo-mask split (reference: loaders.py:34-54)
    _, i_train, i_val = build_pseudo_split(unknown_mask, valid_mask)
    return {
        'cfg': cfg, 'name': name,
        'file_dir': os.path.join(cfg.outdir, name),
        'masked_img': masked_img, 'gt_img': data['gt_img'],
        'unknown_mask': unknown_mask, 'valid_mask': valid_mask,
        'oh': oh, 'ow': ow, 'dh': dh, 'dw': dw,
        'all_angles': all_angles, 'all_periods': all_periods,
        'all_shifts': all_shifts, 'i_train': i_train, 'i_val': i_val,
    }


def _finish_search(prep: dict, distances: np.ndarray, rank_comps: dict,
                   save: bool) -> dict:
    """The odgt record (reference: search.py:221-280) from the ranking's
    outputs; with `save`, also the lattice drawings, the PNGs and
    config.odgt under cfg.outdir/<name>."""
    cfg = prep['cfg']
    file_dir = prep['file_dir']
    all_angles, all_periods = prep['all_angles'], prep['all_periods']
    all_shifts = prep['all_shifts']
    scores = combine_scores(cfg, rank_comps)

    k = min(cfg.topk_detection, len(distances))
    order = np.argsort(distances, kind='stable')[:k]

    best_shifts = [[list(map(float, all_shifts[i][j])) for j in range(2)]
                   for i in order]
    best_periods = [list(map(float, all_periods[i])) for i in order]
    best_angles = [list(map(float, all_angles[i])) for i in order]

    odgt = {
        'fpath_masked_img': f'{file_dir}/masked_img.png',
        'fpath_valid_mask': f'{file_dir}/valid_mask.png',
        'fpath_mask': f'{file_dir}/unknown_mask.png',
        'fpath_gt_img': f'{file_dir}/gt_img.png',
        'selected_angles': best_angles,
        'selected_periods': best_periods,
        'selected_shifts': best_shifts,
        'search_range': list(cfg.search_range),
        'epoch': cfg.N_iters,
        'distances': [float(distances[i]) for i in order],
        # the aux rank gate reads the reference proxy's distances
        # (models/loaders.py::_topk_periodicity)
        'distances_gate': [float(scores['reference'][i]) for i in order],
        'rank_proxy': getattr(cfg, 'rank_proxy', 'reference'),
        # every candidate's lattice and every proxy's score, in detection
        # order
        'rank_candidates': {
            'angles': [list(map(float, a)) for a in all_angles],
            'periods': [list(map(float, p)) for p in all_periods],
            'shifts': [[list(map(float, all_shifts[i][j])) for j in range(2)]
                       for i in range(len(all_shifts))],
            'scores': {name: [float(x) for x in s]
                       for name, s in scores.items()},
            'components': {name: [float(x) for x in c]
                           for name, c in rank_comps.items()},
        },
    }
    for i in range(k):
        odgt[f'fpath_reg_img_{i}'] = f'{file_dir}/reg_img_{i}.png'
    if not save:
        return odgt

    # lattice drawings (reference: search.py:249-269) on the image cropped
    # back from the padded canvas
    oh, ow = prep['oh'], prep['ow']
    masked_img = prep['masked_img'][:oh, :ow]
    unknown_mask = prep['unknown_mask'][:oh, :ow]
    valid_mask = prep['valid_mask'][:oh, :ow]
    ltrb = mask2ltrb(valid_mask[..., 0])
    vis_img = np.uint8(masked_img * 255)
    for i in range(k):
        vis = GridProgram(resolution=vis_img.shape[:2], base_point=ltrb[:2],
                          first_shift=best_shifts[i][0],
                          second_shift=best_shifts[i][1])
        reg_img, _ = vis.draw(vis_img.copy(), color=(255, 255, 0))
        write_rgb(os.path.join(file_dir, f'reg_img_{i}.png'), reg_img / 255.0)
    write_gray(os.path.join(file_dir, 'valid_mask.png'), valid_mask)
    write_gray(os.path.join(file_dir, 'unknown_mask.png'), unknown_mask)
    write_rgb(os.path.join(file_dir, 'masked_img.png'), masked_img)
    write_rgb(os.path.join(file_dir, 'gt_img.png'), prep['gt_img'])
    write_odgt(file_dir, odgt)
    print(f'[search] wrote {file_dir}/config.odgt', flush=True)
    return odgt


def run_search(cfg, percep: Optional[LPIPS] = None,
               contextual: Optional[ContextualLoss] = None, device=None,
               data: Optional[dict] = None, save: bool = True,
               stats: Optional[dict] = None) -> dict:
    """Search one example: cfg.datadir's four PNGs, or `data` (the arrays
    utils/io.py::read_example_dir returns; utils/synthetic.py::
    synthetic_search_data makes them from a seed). Runs on the card unless
    device='cpu' is passed. Returns the odgt record; with save=True it is
    also written, with the PNGs, under cfg.outdir. stats: a
    dict to fill with the phase walls ('detect_s', 'rank_s',
    'artefacts_s', 'total_s': the PhaseTimer phases npp.search.<phase>)
    and rank_proposals' split."""
    def rank(preps, *towers, **kw):
        (p,) = preps
        # ranking (reference: search.py:78-219)
        return [rank_proposals(
            cfg, p['masked_img'], p['i_train'], p['i_val'],
            p['all_angles'], p['all_periods'], *towers,
            norm_res=(p['dh'], p['dw']), return_components=True, **kw)]

    return _search([cfg], [data], rank, percep, contextual, device, save,
                   stats, None, '[search] phases', detected='[search]')[0]


def run_search_suite(cfgs, percep: Optional[LPIPS] = None,
                     contextual: Optional[ContextualLoss] = None,
                     device=None, datas=None, save: bool = True,
                     stats: Optional[dict] = None, mesh: Optional[Mesh] = None,
                     images_axis: str = 'images') -> list:
    """Search every image of a suite with one lockstep ranking fit
    (npp_tpu/proposal/search.py:223-278). Detection, the pseudo-split and
    the record stay per image. The images are padded to the largest
    canvas among them, which changes no distance: the coordinates are
    normalised by each image's tight dims. datas: the images' arrays
    (utils/io.py::read_example_dir's form) instead of their cfg.datadir.
    Returns the odgt records in cfg order. stats: the phase walls
    ('detect_s', 'rank_s', 'artefacts_s', 'total_s') and the ranking's.
    mesh: the ranking's images split over its `images_axis`
    (rank_proposals_suite); every rank detects every image and gets every
    record, and only the mesh's rank 0 writes the files, before a barrier
    that every rank passes once they are written."""
    def rank(preps, *towers, **kw):
        hmax = max(p['masked_img'].shape[0] for p in preps)
        wmax = max(p['masked_img'].shape[1] for p in preps)
        items = []
        for p in preps:
            h, w = p['masked_img'].shape[:2]
            pad3 = ((0, hmax - h), (0, wmax - w), (0, 0))
            items.append({'masked_img': np.pad(p['masked_img'], pad3),
                          'i_train': p['i_train'], 'i_val': p['i_val'],
                          'all_angles': p['all_angles'],
                          'all_periods': p['all_periods'],
                          'norm_res': (p['dh'], p['dw'])})
        return rank_proposals_suite(cfgs[0], items, *towers, mesh=mesh,
                                    images_axis=images_axis, **kw)

    return _search(cfgs, datas or [None] * len(cfgs), rank, percep,
                   contextual, device, save, stats, mesh,
                   f'[search-suite] {len(cfgs)} images')


def _search(cfgs, datas, rank, percep: Optional[LPIPS],
            contextual: Optional[ContextualLoss], device, save: bool,
            stats: Optional[dict], mesh: Optional[Mesh], label: str,
            detected: Optional[str] = None) -> list:
    """Both search entries' span npp.block and phases: detect (each
    cfg's datas entry, or its cfg.datadir where None), rank (the default
    towers where none are given; rank(preps, percep, contextual, device=,
    stats=) -> [(distances, comps)]) and artefacts (the records, written
    by the mesh's rank 0, then a barrier). The walls go into stats and to
    stderr after `label`; `detected` tags a line after detection."""
    device = resolve_device(device)
    stats = {} if stats is None else stats
    timer = PhaseTimer()
    with span('npp.block'):
        with timer.phase('npp.search.detect'):
            preps = [_prepare_search(cfg, read_example_dir(cfg.datadir)
                                     if d is None else d, device)
                     for cfg, d in zip(cfgs, datas)]
        if detected is not None:
            print(f'{detected} {len(preps[0]["all_angles"])} candidates '
                  f'detected ({timer.phases["npp.search.detect"]:.1f}s)',
                  flush=True)
        with timer.phase('npp.search.rank'):
            if percep is None:
                percep = LPIPS(device, net='vgg')
            if contextual is None:
                contextual = ContextualLoss(device)
            ranked = rank(preps, percep, contextual, device=device,
                          stats=stats)
        with timer.phase('npp.search.artefacts'):
            save = save and (mesh is None or mesh.rank == 0)
            odgts = [_finish_search(p, d, c, save)
                     for p, (d, c) in zip(preps, ranked)]
            if mesh is not None:
                mesh.barrier()
    walls = {f'{k}_s': timer.phases.get(f'npp.search.{k}', 0.0)
             for k in PHASES}
    walls['total_s'] = sum(walls.values())
    stats.update(walls)
    print(f'{label}: ' + ' '.join(f'{k[:-2]}={v:.1f}s'
                                  for k, v in walls.items()),
          file=sys.stderr, flush=True)
    return odgts
