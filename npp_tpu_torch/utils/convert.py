"""Carry the JAX package's parameters into the port.

`params_from_jax` takes plain numpy nested dicts (the caller converts the
JAX arrays, e.g. with a tree-map of np.asarray) and never imports JAX:
 - flax Dense {'kernel': (in, out), 'bias': (out,)} -> nn.Linear weight
   (out, in) and bias; a stacked Dense (the search's NPPNetLight,
   {'kernel': (n_cand, in, out), 'bias': (n_cand, out)}) -> the same
   tensors under StackedLinear's 'kernel' and 'bias';
 - flax Conv kernels HWIO -> OIHW;
 - AdaptiveLossParams latents (1, C), one or a tuple of them (the LPIPS
   layers', the style layers'), or stacked (n_cand, 1, C);
 - the warp field's flax Dense tree (dense0.., out) -> WarpField's
   nn.Linear state_dict;
 - the embedder's freq_bands, angles and periods.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def dense_state_dict(mlp: Dict[str, Dict[str, Any]]) -> Dict[str, torch.Tensor]:
    """flax {'<layer>': {'kernel', 'bias'}} -> nn.Module state_dict (an
    nn.Linear's, or a StackedLinear's for a kernel with a candidate axis)."""
    sd = {}
    for name, p in mlp.items():
        kernel = _t(p['kernel'])
        if kernel.dim() == 3:
            sd[f'{name}.kernel'] = kernel
        else:
            sd[f'{name}.weight'] = kernel.T.contiguous()
        sd[f'{name}.bias'] = _t(p['bias'])
    return sd


def conv_hwio_to_oihw(kernel) -> torch.Tensor:
    return _t(kernel).permute(3, 2, 0, 1).contiguous()


def latents_state_dict(lat: Any) -> Dict[str, torch.Tensor]:
    """AdaptiveLossParams as {'latent_alpha', 'latent_scale'} or a
    (latent_alpha, latent_scale) pair -> AdaptiveLossParams state_dict;
    stacked latents (n, 1, C) keep their shape."""
    if isinstance(lat, dict):
        a, s = lat['latent_alpha'], lat['latent_scale']
    else:
        a, s = lat

    def shaped(v):
        v = _t(v)
        return v if v.dim() == 3 else v.reshape(1, -1)
    return {'latent_alpha': shaped(a), 'latent_scale': shaped(s)}


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Map the JAX side's fit parameters and embedder onto the port's.

    tree keys (each optional): 'mlp' and 'warp' (flax Dense trees),
    'adaptive_pix' (latents), 'adaptive_percep' and 'adaptive_style'
    (sequences of latents), 'convs' ({name: HWIO kernel}), 'embedder'
    ({'freq_bands', 'angles', 'periods'}).
    Returns the same keys holding state_dicts / tensors: 'mlp' and the
    latents load with `load_state_dict`, 'convs' are OIHW tensors and
    'embedder' holds tensors for the TaskEmbedder fields."""
    out: Dict[str, Any] = {}
    if 'mlp' in tree:
        out['mlp'] = dense_state_dict(tree['mlp'])
    if 'adaptive_pix' in tree:
        out['adaptive_pix'] = latents_state_dict(tree['adaptive_pix'])
    if 'warp' in tree:
        out['warp'] = dense_state_dict(tree['warp'])
    for key in ('adaptive_percep', 'adaptive_style'):
        if key in tree:
            lats: Sequence = tree[key]
            out[key] = {f'{i}.{k}': v for i, lat in enumerate(lats)
                        for k, v in latents_state_dict(lat).items()}
    if 'convs' in tree:
        out['convs'] = {k: conv_hwio_to_oihw(v) for k, v in tree['convs'].items()}
    if 'embedder' in tree:
        out['embedder'] = {k: _t(v) for k, v in tree['embedder'].items()
                           if v is not None}
    return out
