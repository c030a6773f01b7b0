"""ctypes binding for the alpha-expansion graph cut, a host library.

Port of `npp_tpu/segmentation/graphcut.py`: the same C++ solver
(`csrc/graphcut.cpp`, the port's copy of `npp_tpu/native/graphcut.cpp`),
compiled with g++ into the gitignored `npp_tpu_torch/build/` at first use
(kernels/build.py::build_host_library). API-compatible with pyGCO's
cut_general_graph as the reference calls it (reference:
NPP_segmentation/imsegm/graph_cuts.py:736-748).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np


@functools.lru_cache(maxsize=1)
def _lib():
    from ..kernels.build import build_host_library
    lib = ctypes.CDLL(build_host_library('graphcut'))
    lib.alpha_expansion.restype = ctypes.c_int
    lib.alpha_expansion.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.graphcut_energy.restype = ctypes.c_double
    lib.graphcut_energy.argtypes = lib.alpha_expansion.argtypes[:7] + [
        ctypes.POINTER(ctypes.c_int32)]
    return lib


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def _graph(edges, edge_weights, unary_cost, pairwise_cost):
    return (np.ascontiguousarray(edges, np.int32),
            np.ascontiguousarray(edge_weights, np.float64),
            np.ascontiguousarray(unary_cost, np.float64),
            np.ascontiguousarray(pairwise_cost, np.float64))


def cut_general_graph(edges: np.ndarray, edge_weights: np.ndarray,
                      unary_cost: np.ndarray, pairwise_cost: np.ndarray,
                      algorithm: str = 'expansion', n_iter: int = -1
                      ) -> np.ndarray:
    """Minimise sum unary[v, l_v] + sum_e w_e * pairwise[l_u, l_v]."""
    if algorithm != 'expansion':
        raise ValueError(f'only alpha-expansion is implemented, got {algorithm!r}')
    edges, w, unary, pw = _graph(edges, edge_weights, unary_cost,
                                 pairwise_cost)
    n_nodes, n_labels = unary.shape
    labels = np.zeros(n_nodes, np.int32)
    _lib().alpha_expansion(
        n_nodes, len(edges), n_labels, _ptr(edges, ctypes.c_int32),
        _ptr(w, ctypes.c_double), _ptr(unary, ctypes.c_double),
        _ptr(pw, ctypes.c_double), int(n_iter), _ptr(labels, ctypes.c_int32))
    return labels


def labeling_energy(edges, edge_weights, unary_cost, pairwise_cost, labels
                    ) -> float:
    edges, w, unary, pw = _graph(edges, edge_weights, unary_cost,
                                 pairwise_cost)
    labels = np.ascontiguousarray(labels, np.int32)
    n_nodes, n_labels = unary.shape
    return _lib().graphcut_energy(
        n_nodes, len(edges), n_labels, _ptr(edges, ctypes.c_int32),
        _ptr(w, ctypes.c_double), _ptr(unary, ctypes.c_double),
        _ptr(pw, ctypes.c_double), _ptr(labels, ctypes.c_int32))
