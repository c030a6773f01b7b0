"""Typed configuration, copied from `npp_tpu/config.py` with the same fields
and defaults, so a config written for one package parses in the other.

Mirrors the reference's four configargparse parser builders
(reference: options/arg_config.py:4-300) as frozen dataclasses with identical
defaults, including the per-task differences (loss toggles, weights, iteration
budgets). `npp_tpu_torch.cli` maps flags onto these dataclasses.

Fields that steer the JAX package's compiler or TPU memory have no PyTorch
meaning. The port accepts them, so every config parses, and ignores them;
each one says so below.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class BaseConfig:
    """Shared options (reference: options/arg_config.py:4-38)."""

    lrate: float = 5e-4
    lrate_decay: int = 500           # exponential decay horizon, in 1000s of steps
    chunk: int = 1024 * 32           # ignored by the port: the render chunk
                                     # is fixed at 65,536 rows (trainer.py)
    netchunk: int = 1024 * 4096      # ignored by the port (reference
                                     # network chunking)
    freq_scales: Tuple[float, ...] = (1,)
    freq_offsets: Tuple[float, ...] = (0, -1, 1, 0.5, -0.5)
    angle_offsets: Tuple[float, ...] = (0,)
    i_embed: int = 0                 # 0: positional encoding, -1: identity
    multires: int = 10               # number of Fourier frequency bands
    activation: str = "snake"        # 'snake' | 'relu'
    normalize_type: int = 1          # 1: sigmoid -> [0,1]; 2: tanh -> [-1,1]
    loss_type: str = "robust_loss_adaptive"  # | 'l2' | 'robust_loss'
    adaptive_scale_lo: float = 1e-5  # lower bound of the adaptive robust
                                     # pixel loss's scale c (reference
                                     # default, adaptive.py:164); extended
                                     # schedules should raise it to ~0.01
    seed: int = 0
    matmul_precision: str = "bfloat16"  # the fit's steps and render: TF32
                                        # on the card for the names JAX maps
                                        # to DEFAULT/HIGH, full f32 for
                                        # 'float32'/'highest' (device.py)
    feature_dtype: str = "float32"      # the LPIPS and style towers'
                                        # activation dtype inside the fit
                                        # losses ('bfloat16' or f32); the
                                        # CX tower always runs f32
    canvas_multiple: int = 64           # pad images to this multiple (0 = off)
    canvas_override: Tuple[int, int] = ()  # ignored by the port
    compile_ahead: bool = True          # ignored by the port: nothing is
                                        # compiled ahead in eager PyTorch
    embed_table: str = "float32"        # '' | 'float32' | 'bfloat16': build
                                        # the canvas embedding table in this
                                        # dtype once per block of steps and
                                        # gather rows per step
    embed_table_max_mb: int = 2048      # no table (K1 on the fly) when it
                                        # would exceed this many MB; in
                                        # parallel/runner.py::fit_images the
                                        # B tables of a bucket together
    embed_table_degrade: bool = False   # a bf16 table where an f32 one
                                        # would exceed embed_table_max_mb
    aot_cache_dir: str = ""             # ignored by the port (JAX executable
                                        # cache)
    robust_layout: str = "auto"         # ignored by the port: 'nc' and 'cn'
                                        # give identical values
                                        # (npp_tpu/config.py:135-153)


@dataclass(frozen=True)
class FitConfig(BaseConfig):
    """Shared per-image fit options (completion defaults;
    reference: options/arg_config.py:43-103)."""

    expname: str = "completion"
    basedir: str = "./results"
    datadir: str = ""

    netdepth: int = 8
    netwidth: int = 512
    N_rand: int = 32 * 32 * 8
    patch_num: int = 2
    num_real_patch_per_sample: int = 3
    patch_size_decay: int = 2000
    invalid_as_unknown: bool = False
    p_topk: int = 3
    invalid_ratio: float = 0.3
    aux_gate_ratio: float = 0.0         # drop aux proposals ranked worse than
                                        # ratio x top-1 distance (0 = off)

    # The warp field (nn/warp.py) and the held-out blocks with their
    # snapshot policy (models/heldout.py) are ported; comp_seam='residual'
    # (it needs cv2.inpaint) raises NotImplementedError (see ROADMAP.md).
    warp_field: bool = False
    warp_width: int = 32
    warp_depth: int = 2
    warp_max_px: float = 12.0
    comp_seam: str = "none"
    comp_heldout: int = 0
    comp_heldout_size: int = 0
    comp_snapshot: str = "last"

    use_adaptive_perceptual_loss: bool = True
    no_pix_loss: bool = False
    no_reg_sampling: bool = False
    use_contextual_loss: bool = True
    use_perceptual_loss: bool = True
    use_comp: bool = True
    use_patch_weight: bool = False

    contextual_weight: float = 0.001
    perceptual_weight: float = 0.001

    N_iters: int = 2001
    i_print: int = 500
    i_testset: int = 500

    # filled by the loader from detected periodicity
    # (reference: loaders/loaders.py:130-134)
    patch_size: int = 160


@dataclass(frozen=True)
class CompletionConfig(FitConfig):
    """reference: options/arg_config.py:43-103."""


@dataclass(frozen=True)
class SearchConfig(BaseConfig):
    """Periodicity proposal + ranking (reference: options/arg_config.py:105-146),
    run by proposal/search.py::run_search."""

    datadir: str = ""
    outdir: str = "data/completion/detected"
    netdepth: int = 4
    netwidth: int = 256
    N_rand: int = 32 * 32 * 2
    gray_only: bool = True
    edge_searching: bool = True
    topk_detection: int = 10
    search_range: Tuple[int, int, int] = (1, 10, 1)
    contextual_weight: float = 1.0
    perceptual_weight: float = 30.0
    N_iters: int = 300
    rank_pad_candidates: int = 9        # the suite search stacks every
                                        # image's candidates padded to
                                        # max(the most any image has, this),
                                        # as npp_tpu's does; the padding is
                                        # discarded and distances do not
                                        # depend on it. The one-image
                                        # search pads nothing
    crop_bucket: int = 64               # the eval crop is rounded up to a
                                        # multiple of this (0 = off); it
                                        # changes the scores
    rank_proxy: str = "reference"
    rank_pix_weight: float = 1.0
    cx_mask_pad: bool = False


@dataclass(frozen=True)
class SegmentationConfig(FitConfig):
    """reference: options/arg_config.py:151-225, run by
    models/segmentation.py::run_segmentation."""

    expname: str = "segmentation"
    use_perceptual_loss: bool = False     # store_true in reference (:190)
    contextual_weight: float = 0.005
    perceptual_weight: float = 0.001
    N_iters: int = 601
    i_testset: int = 600

    nb_classes: int = 3
    sp_size: int = 20
    sp_regul: float = 0.1

    l1_thresh: float = 0.15
    lpips_thresh: float = 0.3
    lpips_layers: int = 1
    seg_color_criterion: bool = False
    seg_refine_protect: bool = False
    seg_autocal: str = "auto"
    seg_refine_hysteresis: float = 1.0
    seg_texture_criterion: bool = False
    seg_texture_beta: float = 0.5
    seg_texture_window: int = 9


@dataclass(frozen=True)
class RemappingConfig(FitConfig):
    """reference: options/arg_config.py:231-300, run by
    models/remapping.py::run_remapping."""

    remap_guard: bool = True
    remap_guard_db: float = 10.0

    expname: str = "remapping"
    use_perceptual_loss: bool = False     # store_true in reference (:274)
    use_style_loss: bool = True
    use_adaptive_style_loss: bool = True
    contextual_weight: float = 0.01
    perceptual_weight: float = 0.001
    style_weight: float = 1.0
    N_iters: int = 2801
    i_testset: int = 400

    blur_thresh: float = 50.0


def replace(cfg, **kwargs):
    """Functional update helper (dataclasses.replace re-export)."""
    return dataclasses.replace(cfg, **kwargs)


def nerf_embed_dim(cfg: BaseConfig, input_dims: int, include_input: bool = True) -> int:
    """Output dim of the Fourier encoder per `input_dims` input channels."""
    if cfg.i_embed == -1:
        return input_dims
    d = input_dims if include_input else 0
    return d + input_dims * cfg.multires * 2


def periodic_embed_dim(cfg: BaseConfig, include_input: bool) -> int:
    """Output dim of one proposal's periodicity warp
    (reference: models/embedder.py:102-138: 2 orientations x scales x offsets
    x angle_offsets x {sin, cos} [+ 2 raw coords])."""
    base = 2 if include_input else 0
    per = len(cfg.freq_scales) * len(cfg.freq_offsets) * len(cfg.angle_offsets) * 2 * 2
    return base + per
