"""How far the f32 LPIPS input gradients sit from float64, on the CPU.

    env JAX_PLATFORMS=cpu python scripts/lpips_grad_vs_float64.py

On the inputs of tests/test_torch_losses.py::
test_lpips_robust_value_and_grads_match_jax (three 32x32 patches, seed 1;
latents from seed 2), for plain LPIPS-vgg and LPIPS-robust: the largest
difference of the input gradient from a float64 evaluation of the port's
own LPIPS (its tower, heads and latents cast), relative to the largest
float64 value, for npp_tpu's f32 LPIPS, for the port's f32 LPIPS as it
runs (NCHW-contiguous tower input on the CPU) and for the port's f32 LPIPS
on permuted NHWC (channels-last) input, as it ran before
`nn/features.py::cpu_nchw`; each with PyTorch's oneDNN convolutions on
and off. Prints one JSON line. Needs JAX
(the CPU test host), not a card.
"""
import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from npp_tpu.losses import robust as JR
    from npp_tpu.losses.lpips import LPIPS as JaxLPIPS
    from npp_tpu_torch.losses.lpips import LPIPS
    from npp_tpu_torch.nn import features
    from npp_tpu_torch.utils.convert import latents_state_dict

    torch.set_num_threads(2)
    rng = np.random.RandomState(1)
    a = rng.rand(3, 32, 32, 3).astype(np.float32)
    b = np.clip(a + rng.randn(3, 32, 32, 3).astype(np.float32) * 0.2, 0, 1)
    rng = np.random.RandomState(2)
    jlats = tuple(JR.AdaptiveLossParams(
        latent_alpha=jnp.asarray(rng.randn(1, c).astype(np.float32)),
        latent_scale=jnp.asarray(rng.randn(1, c).astype(np.float32) - 1.0))
        for c in (64, 128, 256, 512, 512))
    jlp, lp = JaxLPIPS(net='vgg'), LPIPS(torch.device('cpu'), net='vgg')
    lp64 = copy.copy(lp)
    lp64.tower = copy.copy(lp.tower)
    lp64.tower.params = {k: (w.double(), bb.double())
                         for k, (w, bb) in lp.tower.params.items()}
    lp64.tower.dtype = torch.float64
    lp64.lins = [x.double() for x in lp.lins]
    lp64.shift, lp64.scale = lp.shift.double(), lp.scale.double()

    def port_grad(mod, dt, robust):
        lats = mod.init_adaptive()
        for p, jl in zip(lats, jlats):
            p.load_state_dict(latents_state_dict(jax.tree.map(np.asarray, jl)))
        x = torch.tensor(a, dtype=dt, requires_grad=True)
        torch.mean(mod(x, torch.tensor(b, dtype=dt), use_robust=robust,
                       adaptive=lats.to(dt), normalize=True)).backward()
        return x.grad.double().numpy()

    out = {}
    nchw = features.cpu_nchw
    for robust in (False, True):
        key = 'robust' if robust else 'plain'
        jg = np.asarray(jax.jit(jax.grad(lambda x: jnp.mean(jlp(
            x, jnp.asarray(b), use_robust=robust, adaptive=jlats,
            normalize=True))))(jnp.asarray(a)), np.float64)
        g64 = port_grad(lp64, torch.float64, robust)
        scale = np.abs(g64).max()
        row = {'largest_f64': float(scale),
               'jax_f32': float(np.abs(jg - g64).max() / scale)}
        for onednn in (True, False):
            with torch.backends.mkldnn.flags(enabled=onednn):
                tag = 'onednn' if onednn else 'native'
                g = port_grad(lp, torch.float32, robust)
                row[f'port_f32_nchw_{tag}'] = float(
                    np.abs(g - g64).max() / scale)
                features.cpu_nchw = lambda x: x
                try:
                    g = port_grad(lp, torch.float32, robust)
                finally:
                    features.cpu_nchw = nchw
                row[f'port_f32_channels_last_{tag}'] = float(
                    np.abs(g - g64).max() / scale)
        out[key] = row
    print(json.dumps(out))


if __name__ == '__main__':
    main()
