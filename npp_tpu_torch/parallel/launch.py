"""Running a function in a process group of several processes on one
machine, and the port's multi-process dry run.

`spawn` starts one process per rank (the 'spawn' start method: each
child imports only the function's module), joins them in a
torch.distributed group through a file:// init and returns every rank's
result as host copies, raising when a rank fails or misses the deadline.
The workers here are what a sharded run calls inside the group:
`with_mesh` calls an entry point with a mesh over the group,
`render_sharded` renders one image pixel-sharded, `sharded_fit_step`
takes one batched step with the images sharded (on injected batches if
given). They live in the port so that a child never imports the module
of a caller that imports JAX; every child checks that it holds no JAX.

    python -c 'from npp_tpu_torch.parallel.launch import dryrun_multichip;
               dryrun_multichip(8)'

runs `dryrun_multichip`, the counterpart of npp_tpu's
__graft_entry__.py::dryrun_multichip, over 8 CPU ranks under gloo.
"""
from __future__ import annotations

import copy
import datetime
import multiprocessing as mp
import os
import queue
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..device import matmul_precision, resolve_device
from ..models.trainer import (COMPLETION_TASK, FitState, TaskSpec,
                              fit_step, init_fit_state, make_adam,
                              make_schedule)
from .mesh import image_sharding, make_mesh, mean_over_mesh


def to_host(obj):
    """A picklable host copy: tensors as numpy arrays, a FitState as its
    named parameters, Adam moments and step, a module as its state dict;
    containers element by element."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, FitState):
        named = dict(obj.params.named_parameters())
        moments = {k: obj.optimizer.state.get(p, {}) for k, p in named.items()}
        return {'params': to_host(named),
                'exp_avg': {k: to_host(m['exp_avg'])
                            for k, m in moments.items() if m},
                'exp_avg_sq': {k: to_host(m['exp_avg_sq'])
                               for k, m in moments.items() if m},
                'step': obj.step}
    if isinstance(obj, nn.Module):
        return to_host(dict(obj.state_dict()))
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


_THREAD_VARS = ('OMP_NUM_THREADS', 'OPENBLAS_NUM_THREADS', 'MKL_NUM_THREADS')


def _child(fn, rank, world, backend, init_file, args, timeout, results,
           cuda, env, threads):
    try:
        if threads:
            torch.set_num_threads(threads)
        os.environ.update(env or {})
        if cuda:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        if backend is not None:
            dist.init_process_group(
                backend, init_method=f'file://{init_file}', world_size=world,
                rank=rank, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = to_host(fn(*args))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        if 'jax' in sys.modules:
            raise RuntimeError('a rank imported jax')
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world: int, backend: Optional[str],
          init_file: Optional[str] = None, args: Sequence = (),
          timeout: float = 60.0, cuda: bool = False,
          env: Optional[Sequence[dict]] = None,
          threads: Optional[int] = 1) -> List[Any]:
    """fn(*args) in `world` new processes; returns their results in rank
    order (to_host copies).

    backend: each child first joins a group of `world` ranks through
    `init_file` (a path no earlier group used) with `timeout` on every
    collective, and leaves it after fn; None: fn joins one itself (e.g.
    multihost.initialize). cuda: each rank's current card is rank modulo
    the card count. env: per-rank environment entries. threads: torch's,
    OpenMP's and BLAS's CPU threads in each child. Raises RuntimeError with a rank's
    traceback if it fails or exits without a result, TimeoutError if the
    ranks are not all done within `timeout` seconds (every child is
    killed before either is raised)."""
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, daemon=True, args=(
        fn, r, world, backend, init_file, args, timeout, results, cuda,
        None if env is None else env[r], threads)) for r in range(world)]
    deadline = time.monotonic() + timeout
    got = {}
    # the children's BLAS and OpenMP pools size themselves when numpy and
    # torch load, from the environment they inherit at start
    saved = dict(os.environ)
    try:
        if threads:
            os.environ.update({k: str(threads) for k in _THREAD_VARS})
        try:
            for p in procs:
                p.start()
        finally:
            os.environ.clear()
            os.environ.update(saved)
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f'ranks {sorted(set(range(world)) - set(got))}'
                                   f' not done within {timeout} s')
            try:
                rank, ok, out = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f'ranks {dead} exited '
                                       f'{[procs[r].exitcode for r in dead]} '
                                       'without a result')
                continue
            if not ok:
                raise RuntimeError(f'rank {rank} failed:\n{out}')
            got[rank] = out
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f'ranks exited {codes}')
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


# ---- workers: what a rank runs inside the group ------------------------

def in_turn(*calls: Callable) -> list:
    """Each call in order (functools.partial objects): several sharded
    runs in one group."""
    return [c() for c in calls]


def with_mesh(axis_names: Sequence[str], shape, fn: Callable, *args,
              **kwargs):
    """fn(*args, mesh=<a mesh of `axis_names` and `shape` over the default
    group>, **kwargs): fit_images, rank_proposals, rank_proposals_suite or
    run_search_suite sharded."""
    return fn(*args, mesh=make_mesh(axis_names, shape), **kwargs)


def mesh_probe(tree, axis_names: Sequence[str] = ('images',), shape=None,
               axis: str = 'images') -> dict:
    """A mesh over the default group: its shape, this rank's coordinates,
    and `tree` sharded (mesh.py::shard_leading_axis) and gathered back
    (gather_leading_axis, the padding dropped): the layout's round trip."""
    from .mesh import gather_leading_axis, shard_leading_axis
    mesh = make_mesh(axis_names, shape)
    block = shard_leading_axis(tree, mesh, axis)
    n = {k: v.shape[0] for k, v in tree.items()}
    return {'shape': mesh.shape, 'coords': mesh.coords, 'block': block,
            'gathered': {k: gather_leading_axis(v, mesh, axis, n[k])
                         for k, v in block.items()}}


def render_sharded(cfg, embedder, params, h: int, w: int,
                   axis_names: Sequence[str] = ('pixels',), shape=None,
                   **kwargs) -> torch.Tensor:
    """parallel/batch.py::make_sharded_render(...)(params, h, w) over a
    mesh of the default group."""
    from .batch import make_sharded_render
    mesh = make_mesh(axis_names, shape)
    return make_sharded_render(cfg, embedder, mesh, axis_names[0],
                               **kwargs)(params, h, w)


def sharded_fit_step(cfg, datas, patch_size: int = 16,
                     task: TaskSpec = COMPLETION_TASK, params=None,
                     inject=None, bands=None, device='cpu') -> dict:
    """One batched fit step of `datas` (one canvas) with the images split
    over the default group's 'images' axis, npp_tpu's
    make_batched_fit_step(mesh=...) in the port: each rank stacks its
    block (padded by repeating the last image) and steps it, then the
    metrics are averaged over the ranks ('loss' the mean over the images,
    npp_tpu's) and the stacked state gathered. Images of other sizes are
    padded into the largest canvas, each embedding normalised by its own
    dims, as fit_images does.

    params: per image, state dicts of FitParams' parts ({'mlp': ...,
    'adaptive_pix': ..., 'adaptive_percep': ...}) to start from (default:
    the init every image shares); inject: per image (pixel indices,
    PatchBatch), used instead of drawing; bands: the Fourier bands of
    every embedder. Returns {'metrics': floats, 'states': per-image
    FitStates}."""
    from ..models.pipeline import build_components, make_fit_consts
    from ..nn.embedder import make_task_embedder
    from .batch import (build_batched_loss_fn, gather_fit_state,
                        stack_consts, stack_embedders, stack_modules,
                        unstack_fit_state)
    from .runner import pad_to_canvas
    device = resolve_device(device)
    h = max(d.img.shape[0] for d in datas)
    w = max(d.img.shape[1] for d in datas)
    mesh = make_mesh(('images',))
    sh = image_sharding(mesh)
    n = len(datas)
    mine = (list(range(n)) + [n - 1] * (sh.padded(n) - n))[sh.rows(n)]
    comps = build_components(cfg, datas[0], device, task)
    embs = []
    for j in mine:
        e = make_task_embedder(
            cfg, np.asarray(datas[j].selected_angles),
            np.asarray(datas[j].selected_periods), datas[j].img.shape[:2],
            torch.Generator().manual_seed(cfg.seed), device)
        if bands is not None:
            e.freq_bands = torch.as_tensor(np.asarray(bands),
                                           dtype=torch.float32, device=device)
        embs.append(e)
    template = init_fit_state(cfg, comps.model, comps.percep, device,
                              comps.style).params
    singles = []
    for j in mine:
        p = copy.deepcopy(template)
        for part, sd in (params[j] if params is not None else {}).items():
            getattr(p, part).load_state_dict(sd)
        singles.append(p)
    params_b = stack_modules(singles)
    state = FitState(params_b, make_adam(params_b.parameters(), cfg.lrate), 0)
    emb_b = stack_embedders(embs)
    consts = stack_consts([make_fit_consts(cfg, pad_to_canvas(datas[j], h, w),
                                           patch_size, device, task)
                           for j in mine])
    loss_fn = build_batched_loss_fn(
        cfg, comps.percep, comps.contextual, cfg.patch_num, patch_size,
        comps.style, task, res=emb_b.res,
        inject=None if inject is None else
        ([inject[0][j] for j in mine], [inject[1][j] for j in mine]))
    gens = [torch.Generator().manual_seed(cfg.seed + 1) for _ in mine]
    with matmul_precision(cfg.matmul_precision):
        metrics = fit_step(state, loss_fn, emb_b, consts, gens,
                           make_schedule(cfg))
    metrics['loss'] = metrics['loss'] / len(mine)
    metrics = {k: float(mean_over_mesh(torch.as_tensor(
        v, dtype=torch.float32, device=device).detach(), mesh))
        for k, v in metrics.items()}
    full = gather_fit_state(state, template, mesh, n)
    return {'metrics': metrics,
            'states': [unstack_fit_state(full, template, j)
                       for j in range(n)]}


def allreduce_probe(backend: str = 'gloo', timeout_s: float = 60.0) -> dict:
    """Join the group that multihost.initialize finds in the environment
    and all-reduce rank + 1 over it."""
    from .multihost import initialize
    initialize(backend=backend, timeout_s=timeout_s)
    t = torch.tensor([dist.get_rank() + 1.0])
    dist.all_reduce(t)
    return {'rank': dist.get_rank(), 'world': dist.get_world_size(),
            'sum': float(t)}


# ---- the dry run ----------------------------------------------------------

def tiny_data(seed: int, h: int = 48, w: int = 56, patch_size: int = 16):
    """A small random example with a hole (npp_tpu's
    __graft_entry__.py::_tiny_setup, its image drawn from `seed`)."""
    from ..models.loaders import TaskData
    img = np.random.RandomState(seed).rand(h, w, 3)
    mask = np.ones((h, w, 1))
    mask[h // 3: h // 2, w // 3: w // 2] = 0
    valid = np.ones((h, w, 1))
    return TaskData(
        img=img, masked_img=img, mask=mask, valid_mask=valid,
        i_train=np.stack(np.nonzero((mask * valid)[..., 0]), 1),
        i_val=np.stack(np.nonzero(((1 - mask) * valid)[..., 0]), 1),
        selected_shifts=[[[12.0, 0.0], [0.0, 14.0]]] * 3,
        selected_angles=[[90.0, 180.0]] * 3,
        selected_periods=[[12.0, 14.0]] * 3, patch_size=patch_size)


def _dryrun_rank(n: int) -> dict:
    from ..config import CompletionConfig, replace
    from ..nn.embedder import make_task_embedder
    from .batch import make_sharded_render
    cfg = replace(CompletionConfig(), netwidth=64, netdepth=4, N_rand=128,
                  patch_num=1, num_real_patch_per_sample=2,
                  use_perceptual_loss=False)
    datas = [tiny_data(i) for i in range(n)]
    out = sharded_fit_step(cfg, datas)
    d = datas[0]
    emb = make_task_embedder(cfg, np.asarray(d.selected_angles),
                             np.asarray(d.selected_periods), d.img.shape[:2],
                             torch.Generator().manual_seed(cfg.seed),
                             torch.device('cpu'))
    img = make_sharded_render(cfg, emb, make_mesh(('pixels',)),
                              chunk=1 << 9)(out['states'][0].params, 48, 56)
    if img.shape != (48, 56, 3) or not bool(torch.isfinite(img).all()):
        raise RuntimeError(f'sharded render: shape {tuple(img.shape)}')
    return {'loss': out['metrics']['loss'], 'render_shape': tuple(img.shape)}


def dryrun_multichip(n: int, timeout: float = 300.0) -> dict:
    """One batched completion step of n tiny images sharded over n CPU
    ranks under gloo (one image each, CX on, LPIPS off), then image 0
    rendered pixel-sharded over them; the loss must be finite and the
    same on every rank."""
    with tempfile.TemporaryDirectory() as tmp:
        outs = spawn(_dryrun_rank, n, 'gloo', os.path.join(tmp, 'init'),
                     args=(n,), timeout=timeout)
    losses = [o['loss'] for o in outs]
    if not np.all(np.isfinite(losses)) or len(set(losses)) != 1:
        raise RuntimeError(f'dryrun_multichip({n}): losses {losses}')
    print(f'dryrun_multichip({n}): completion step loss={losses[0]:.4f} on '
          f'{n} gloo ranks, pixel-sharded render ok', flush=True)
    return outs[0]
