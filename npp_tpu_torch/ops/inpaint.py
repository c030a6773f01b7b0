"""Navier-Stokes inpainting of 8-bit images, the port's own host library.

`inpaint_ns(src, mask, radius)` returns what
`cv2.inpaint(src, mask, radius, cv2.INPAINT_NS)` returns, pixel for pixel,
for uint8 images with 1 or 3 channels; npp_tpu's seam-aware residual
composite calls that (npp_tpu/models/completion.py:21-47). The work is
`csrc/inpaint_ns.cpp`, compiled with g++ into the gitignored
`npp_tpu_torch/build/` at first use (kernels/build.py::build_host_library)
and bound with ctypes, as the segmentation's graph cut is. If the build
fails, the call raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np


@functools.lru_cache(maxsize=1)
def _lib():
    from ..kernels.build import build_host_library
    lib = ctypes.CDLL(build_host_library('inpaint_ns'))
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.npp_inpaint_ns.argtypes = [u8, u8, u8, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_double]
    lib.npp_inpaint_ns.restype = ctypes.c_int
    return lib


def inpaint_ns(src: np.ndarray, mask: np.ndarray, radius: float = 3.0
               ) -> np.ndarray:
    """src (H, W) or (H, W, 3) uint8; mask (H, W) uint8, non-zero where
    the pixels are unknown; radius the neighbourhood's radius (rounded and
    clamped to 1..100). Returns a new array of src's shape."""
    src = np.ascontiguousarray(src)
    mask = np.ascontiguousarray(mask)
    if src.dtype != np.uint8 or mask.dtype != np.uint8:
        raise TypeError('inpaint_ns takes uint8 images and masks')
    if src.ndim == 3 and src.shape[2] == 1:
        src = src[..., 0]
    if src.ndim not in (2, 3) or (src.ndim == 3 and src.shape[2] != 3):
        raise ValueError(f'inpaint_ns takes 1- or 3-channel images, '
                         f'got {src.shape}')
    if mask.shape != src.shape[:2]:
        raise ValueError(f'mask {mask.shape} does not match {src.shape}')
    h, w = src.shape[:2]
    cn = 1 if src.ndim == 2 else 3
    out = np.empty_like(src)
    ptr = ctypes.POINTER(ctypes.c_uint8)
    status = _lib().npp_inpaint_ns(
        src.ctypes.data_as(ptr), mask.ctypes.data_as(ptr),
        out.ctypes.data_as(ptr), h, w, cn, float(radius))
    if status != 0:
        raise RuntimeError(f'npp_inpaint_ns failed ({status})')
    return out
