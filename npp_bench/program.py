"""The system under test of the two fit kinds (programs/fit_block.py,
programs/batched_fit_block.py): the port's fit of a cell, built as its own
entries build it, and the hooks that read what its first steps did.

`build` makes one of two programs, as the kind asks:
 - one image (kind 'fit_block'): `models/trainer.py::make_fit_block`'s
   run_block, built as `models/pipeline.py::fit_image` builds its first
   stage (components, FitState, FitConsts at the loader's patch size, the
   batch generator seeded with the fit's seed + 1);
 - B images stacked (kind 'batched_fit_block'):
   `parallel/batch.py::make_batched_fit_block`'s run_block, built as
   `parallel/runner.py::fit_images` builds one bucket (the images'
   embedders stacked, one FitState stacked B times, a generator per image,
   the canvas table under the runner's size guard over the B tables
   together).
The blocks are built once, at the configuration's starting patch size.
Everything outside the blocks runs in full f32, as in a fit. A kind
(programs/__init__.py) provides its inputs, build, first block, check,
limits, work and calibration; `build` here is the fit kinds' build, and the
harness reads the Fit's run_block, state, feed, images, block and table
(the rest is the fit kinds' own, fit.py).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

SOURCE_SAME = 2
TERMS = ('pixel', 'contextual', 'perceptual', 'style')   # the loss's terms
MAX_FOLLOW = 10     # steps the check may follow, waiting for a 'same' batch


@dataclasses.dataclass
class Fit:
    run_block: Callable
    state: object          # the port's FitState (stacked for B images)
    feed: object           # the generator, or the B generators
    images: int
    stacked: bool
    block: int
    patch_size: int
    table: Optional[str]   # the canvas table's dtype, or None (K1 on the fly)


def _config(config: dict, seed: int):
    from npp_tpu_torch import config as port_config
    cls = getattr(port_config, config['config_class'])
    fields = dict(config['config'])
    for k, v in fields.items():
        if isinstance(v, list):
            fields[k] = tuple(v)
    return dataclasses.replace(cls(), seed=seed, **fields)


def _task(config: dict):
    """The port's task of a fit configuration: completion or remapping,
    the fits the reference follows (reference/fit.py::task_of)."""
    if config['task'] == 'remapping':
        from npp_tpu_torch.models.remapping import REMAPPING_TASK
        return REMAPPING_TASK
    if config['task'] == 'completion':
        from npp_tpu_torch.models.trainer import COMPLETION_TASK
        return COMPLETION_TASK
    raise ValueError(f'no fit of the task {config["task"]!r}')


def task_data(config: dict, arrays: dict, cfg, device):
    """The port's TaskData of the benchmark's arrays: completion's as the
    port's synthetic example carries them; remapping's through the port's
    loader (`models/loaders.py::remapping_data`: the blur map on the card,
    the clear mask, the pools)."""
    from npp_tpu_torch.models.loaders import TaskData, remapping_data
    if config['task'] == 'remapping':
        return remapping_data(arrays, cfg, device)
    keys = ('img', 'masked_img', 'mask', 'valid_mask', 'i_train', 'i_val',
            'selected_shifts', 'selected_angles', 'selected_periods',
            'patch_size')
    return TaskData(**{k: arrays[k] for k in keys})


def build(config: dict, traffic: dict, arrays: List[dict], seed: int,
          device, stacked: bool) -> Fit:
    """The cell's fit on `device`, from the benchmark's arrays (one dict
    per image): the single-image block, or with `stacked` the batched
    one."""
    from npp_tpu_torch.device import matmul_precision
    from npp_tpu_torch.models.pipeline import build_components, make_fit_consts
    from npp_tpu_torch.models.trainer import (init_fit_state, make_fit_block,
                                              table_dtype, table_guard)
    cfg = _config(config, seed)
    task = _task(config)
    block = int(traffic['block'])
    with matmul_precision('float32'):
        datas = [task_data(config, a, cfg, device) for a in arrays]
        ps = datas[0].patch_size
        if ps != config['image']['patch_size']:
            raise ValueError(f'the loader gives patch {ps}, the configuration '
                             f'file says {config["image"]["patch_size"]}')
        if not stacked:
            comps = build_components(cfg, datas[0], device, task)
            state = init_fit_state(cfg, comps.model, comps.percep, device,
                                   comps.style)
            consts = make_fit_consts(cfg, datas[0], ps, device, task)
            run_block = make_fit_block(cfg, comps.embedder, consts,
                                       comps.percep, comps.contextual,
                                       cfg.patch_num, ps, block, comps.style,
                                       task)
            feed = torch.Generator().manual_seed(cfg.seed + 1)
            dtype = table_dtype(cfg, comps.embedder, block)
        else:
            from npp_tpu_torch.nn.embedder import make_task_embedder
            from npp_tpu_torch.parallel.batch import (init_batched_state,
                                                      make_batched_fit_block,
                                                      stack_consts,
                                                      stack_embedders)
            h, w = datas[0].img.shape[:2]
            emb_b = stack_embedders([make_task_embedder(
                cfg, np.asarray(d.selected_angles),
                np.asarray(d.selected_periods), d.img.shape[:2],
                torch.Generator().manual_seed(cfg.seed), device)
                for d in datas])
            comps = build_components(cfg, datas[0], device, task)
            state0 = init_fit_state(cfg, comps.model, comps.percep, device,
                                    comps.style)
            state = init_batched_state(cfg, state0, len(datas))
            dtype = table_guard(cfg, len(datas) * h * w * emb_b.out_dim)
            consts = stack_consts([make_fit_consts(cfg, d, ps, device, task)
                                   for d in datas])
            run_block = make_batched_fit_block(
                cfg, emb_b, consts, comps.percep, comps.contextual,
                cfg.patch_num, ps, block, comps.style, task, grid_hw=(h, w),
                table=dtype)
            feed = [torch.Generator().manual_seed(cfg.seed + 1)
                    for _ in datas]

    def run(state_, feed_):
        with matmul_precision('float32'):
            return run_block(state_, feed_)

    return Fit(run, state, feed, len(datas), stacked, block, ps,
               None if dtype is None else str(dtype).split('.')[-1])


# ---- what the first steps did ----------------------------------------------


def _leaves(params, stacked: bool) -> Dict[str, List[torch.Tensor]]:
    """{leaf name as the single-image FitParams names it: [image j's
    slice]}: a stacked layer's kernel (B, in, out) is the weight of image
    j transposed, which keeps its norm."""
    out = {}
    for name, p in params.named_parameters():
        key = name[:-len('kernel')] + 'weight' if name.endswith('.kernel') \
            else name
        out[key] = list(p.unbind(0)) if stacked else [p]
    return out


@dataclasses.dataclass
class Record:
    """The program's first steps, read through its own block: each step's
    loss and branch, Adam's first moment after step 1, and the parameters
    at the start and after the last step followed: the third, or with
    wait_same the first 'same' batch (the only ones LPIPS runs on) if that
    comes later, up to `limit`."""
    stacked: bool
    wait_same: bool = False    # follow on to the first 'same' batch
    limit: int = MAX_FOLLOW
    losses: List[torch.Tensor] = dataclasses.field(default_factory=list)
    sources: List[int] = dataclasses.field(default_factory=list)
    terms: List[Dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=list)
    pred: Optional[torch.Tensor] = None   # step 1's MLP output
    start: Dict[str, List[torch.Tensor]] = None
    first_moment: Dict[str, List[torch.Tensor]] = None
    after: Dict[str, List[torch.Tensor]] = None
    followed: int = 0
    # K3 in step 1, on the host: its inputs xn, yn (N, P, C), its output z
    # (N, Q), the upstream gradient dz it was handed and its gradient dx
    # in xn; filled by cx_call
    cx: Optional[Dict[str, torch.Tensor]] = None

    def begin(self, state) -> None:
        self.start = {k: [t.detach().clone() for t in v]
                      for k, v in _leaves(state.params, self.stacked).items()}

        def first_output(module, args, output):
            self.pred = output.detach().clone()
            self._hook.remove()

        self._hook = state.params.mlp.register_forward_hook(first_output)

    def on_step(self, state, metrics) -> None:
        if self.after is not None:
            return
        n = len(self.losses) + 1
        self.losses.append(metrics['loss'].detach().clone())
        self.sources.append(int(round(float(metrics['source']))))
        self.terms.append({k: v.detach().clone() for k, v in metrics.items()
                           if k in TERMS})
        if n == 1:
            moments = {}
            for name, p in state.params.named_parameters():
                st = state.optimizer.state.get(p, {})
                moments[name] = st['exp_avg'].clone() if 'exp_avg' in st \
                    else torch.zeros_like(p)
            self.first_moment = _leaves(_Named(moments), self.stacked)
        if n >= min(3, self.limit) and (not self.wait_same or
                                        SOURCE_SAME in self.sources or
                                        n >= self.limit):
            self.followed = n
            self.after = {k: [t.detach().clone() for t in v] for k, v in
                          _leaves(state.params, self.stacked).items()}

    def cx_call(self, kernel, xn, yn, band_width, feat_valid=None):
        """K3 (`kernel`) as the CX loss calls it; step 1's call is kept."""
        z = kernel(xn, yn, band_width, feat_valid)
        if self.cx is not None or self.losses or feat_valid is not None:
            return z
        cx = self.cx = {'xn': xn.detach().cpu(), 'yn': yn.detach().cpu(),
                        'z': z.detach().cpu(), 'band_width': band_width}

        def keep(name):
            def hook(grad):
                cx[name] = grad.detach().cpu()
            return hook

        if z.requires_grad:
            z.register_hook(keep('dz'))
            xn.register_hook(keep('dx'))
        return z

    def to_host(self) -> None:
        def host(d):
            return {k: [t.cpu() for t in v] for k, v in d.items()}
        self.losses = [float(x) for x in self.losses[:self.followed]]
        self.sources = self.sources[:self.followed]
        self.terms = [{k: float(v) for k, v in t.items()}
                      for t in self.terms[:self.followed]]
        self.pred = self.pred.float().cpu()
        self.start, self.after = host(self.start), host(self.after)
        self.first_moment = host(self.first_moment)


class _Named:
    """named_parameters() over a plain dict of tensors."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self._t = tensors

    def named_parameters(self):
        return iter(self._t.items())


@contextlib.contextmanager
def recording(record: Record):
    """Within the block, every fit step of the port (the single-image and
    the batched block both call `models/trainer.py::fit_step` by name)
    reports to `record` after it returns, and the CX loss's calls of K3
    (`losses/contextual.py` calls `cx_colmax` by name) go through
    `record.cx_call`."""
    from npp_tpu_torch.losses import contextual
    from npp_tpu_torch.models import trainer
    from npp_tpu_torch.parallel import batch
    inner, kernel = trainer.fit_step, contextual.cx_colmax

    def step(state, loss_fn, embedder, consts, gen, schedule):
        metrics = inner(state, loss_fn, embedder, consts, gen, schedule)
        record.on_step(state, metrics)
        return metrics

    def cx_colmax(xn, yn, band_width, feat_valid=None):
        return record.cx_call(kernel, xn, yn, band_width, feat_valid)

    trainer.fit_step = batch.fit_step = step
    contextual.cx_colmax = cx_colmax
    try:
        yield
    finally:
        trainer.fit_step = batch.fit_step = inner
        contextual.cx_colmax = kernel
