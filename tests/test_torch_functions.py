"""The small public functions of `npp_tpu` that the port gained with the
seam slice, against npp_tpu's on the CPU: the contextual loss's 'l1' and
'l2' distances, the log and linear Fourier bands, and the robust loss's
exp_safe, inv_affine_sigmoid and element-wise adaptive_lossfun."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npp_tpu.losses import contextual as JC
from npp_tpu.losses import robust as JR
from npp_tpu.nn import embedder as JE
from npp_tpu_torch.losses import contextual as TC
from npp_tpu_torch.losses import robust as TR
from npp_tpu_torch.nn import embedder as TE
from npp_tpu_torch.utils.convert import latents_state_dict
from tests.torch_threads import few_threads  # noqa: F401  (autouse)


@pytest.mark.parametrize('loss_type', ['l1', 'l2', 'cosine'])
def test_contextual_loss_types_match_jax(loss_type):
    """Distances, the loss and its gradient in x, with and without a
    position mask: rtol 1e-5 on the distances and the loss, 1e-4 on the
    gradient (of its largest magnitude; the softmax reassociates)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 6, 8).astype(np.float32)
    y = rng.randn(2, 5, 6, 8).astype(np.float32)
    fv = (rng.rand(2, 5, 6) > 0.2).astype(np.float32)
    if loss_type != 'cosine':
        dist = {'l1': (JC.compute_l1_distance, TC.compute_l1_distance),
                'l2': (JC.compute_l2_distance, TC.compute_l2_distance)}
        jd, td = dist[loss_type]
        np.testing.assert_allclose(
            td(torch.tensor(x), torch.tensor(y)).numpy(),
            np.asarray(jd(jnp.asarray(x), jnp.asarray(y))), rtol=1e-5,
            atol=1e-5)
    for mask in (None, fv):
        def jf(xx):
            return JC.contextual_loss(
                xx, jnp.asarray(y), loss_type=loss_type,
                feat_valid=None if mask is None else jnp.asarray(mask))

        jv, jg = jax.value_and_grad(jf)(jnp.asarray(x))
        xt = torch.tensor(x, requires_grad=True)
        v = TC.contextual_loss(
            xt, torch.tensor(y), loss_type=loss_type,
            feat_valid=None if mask is None else torch.tensor(mask))
        v.backward()
        np.testing.assert_allclose(float(v.detach()), float(jv), rtol=1e-5)
        g, jg = xt.grad.numpy(), np.asarray(jg)
        assert np.abs(g - jg).max() <= 1e-4 * np.abs(jg).max()
    with pytest.raises(ValueError):
        TC.contextual_loss(torch.tensor(x), torch.tensor(y), loss_type='l3')


def test_freq_bands_match_jax():
    """log and linear bands: rtol 1e-6 (linspace in f32)."""
    for n, top in ((10, 9.0), (4, 3.0), (1, 0.0)):
        np.testing.assert_allclose(TE.log_freq_bands(n, top).numpy(),
                                   np.asarray(JE.log_freq_bands(n, top)),
                                   rtol=1e-6)
        np.testing.assert_allclose(TE.linear_freq_bands(n, top).numpy(),
                                   np.asarray(JE.linear_freq_bands(n, top)),
                                   rtol=1e-6)


def test_robust_helpers_match_jax():
    """exp_safe (clamped at 87.5), inv_affine_sigmoid (numpy, the inverse
    of affine_sigmoid) and adaptive_lossfun element by element with its
    latents' gradients: rtol 1e-5 on values, 1e-4 on gradients (of their
    largest magnitude)."""
    x = np.asarray([-5.0, 0.0, 3.0, 87.0, 90.0, 1e4], np.float32)
    np.testing.assert_allclose(TR.exp_safe(torch.tensor(x)).numpy(),
                               np.asarray(JR.exp_safe(jnp.asarray(x))),
                               rtol=1e-6)
    p = np.asarray([0.01, 0.3, 0.5, 0.99])
    np.testing.assert_array_equal(TR.inv_affine_sigmoid(p, 0.0, 1.0),
                                  JR.inv_affine_sigmoid(p, 0.0, 1.0))
    np.testing.assert_allclose(
        TR.affine_sigmoid(torch.tensor(TR.inv_affine_sigmoid(
            p, 0.001, 1.999)), 0.001, 1.999).numpy(), p, rtol=1e-12)

    rng = np.random.RandomState(1)
    r = rng.randn(40, 5).astype(np.float32) * 2
    jp = JR.AdaptiveLossParams(
        latent_alpha=jnp.asarray(rng.randn(1, 5).astype(np.float32)),
        latent_scale=jnp.asarray(rng.randn(1, 5).astype(np.float32) - 1))

    def jf(p):
        return jnp.sum(JR.adaptive_lossfun(jnp.asarray(r), p))

    want = np.asarray(JR.adaptive_lossfun(jnp.asarray(r), jp))
    jg = jax.grad(jf)(jp)
    tp = TR.adaptive_init(5)
    tp.load_state_dict(latents_state_dict(jax.tree.map(np.asarray, jp)))
    got = TR.adaptive_lossfun(torch.tensor(r), tp)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    got.sum().backward()
    for name in ('latent_alpha', 'latent_scale'):
        g, w = getattr(tp, name).grad.numpy(), np.asarray(getattr(jg, name))
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), name
