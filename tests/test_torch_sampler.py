"""Port parity on the CPU for the patch sampler: patch extraction, window
sums and the lattice real-patch selection, on the same numpy inputs and
centroids through `npp_tpu` and `npp_tpu_torch`. Everything after the
random draws is integer or exact-f32 arithmetic, so the comparisons are
exact."""
import hashlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npp_tpu.models import sampler as JS
from npp_tpu.ops import glimpse as JG
from npp_tpu_torch.models import sampler as TS
from npp_tpu_torch.models.trainer import draw_batch
from npp_tpu_torch.ops import glimpse as TG
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

CPU = torch.device('cpu')


def _scene(h=120, w=140, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.rand(h, w, 3).astype(np.float32)
    mask = np.ones((h, w), np.float32)
    mask[40:60, 50:80] = 0
    train = np.stack(np.nonzero(mask), 1)
    val = np.stack(np.nonzero(1 - mask), 1)
    return img, mask, train, val


@pytest.mark.parametrize('size', [4, 7, 32])
def test_extract_patches_and_window_sum_match_jax(size):
    img, mask, _, _ = _scene()
    rng = np.random.RandomState(size)
    # centres inside, on and beyond the borders (zero padding)
    cents = np.stack([rng.randint(-5, 125, 40), rng.randint(-5, 145, 40)],
                     -1).astype(np.int32)
    want = np.asarray(jax.jit(JG.extract_patches, static_argnums=2)(
        jnp.asarray(img), jnp.asarray(cents), size))
    got = TG.extract_patches(torch.as_tensor(img), torch.as_tensor(cents),
                             size).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TG.patch_grid(torch.as_tensor(cents), size).numpy(),
        np.asarray(JG.patch_grid(jnp.asarray(cents), size)))
    jsat = JG.summed_area_table(jnp.asarray(mask))
    tsat = TG.summed_area_table(torch.as_tensor(mask))
    np.testing.assert_array_equal(tsat.numpy(), np.asarray(jsat))
    np.testing.assert_array_equal(
        TG.window_sum(tsat, torch.as_tensor(cents), size).numpy(),
        np.asarray(JG.window_sum(jsat, jnp.asarray(cents), size)))


@pytest.mark.parametrize('shifts', [
    [[[20.0, 0.0], [0.0, 24.0]]],          # axis-aligned lattice
    [[[17.5, 3.0], [-4.0, 21.0]]],         # oblique, non-integer vectors
])
def test_real_from_lattice_matches_jax(shifts):
    """Real-patch selection on given centroids. The L1 lattice distances
    are integers and tie all the time (the 4 neighbours at distance 1,
    ...), so this also pins the tie order: lower candidate index first, as
    lax.top_k gives it."""
    img, mask, train, val = _scene()
    jc = JS.build_sampler_consts(img, mask, train, val, shifts, 32)
    tc = TS.build_sampler_consts(img, mask, train, val, shifts, 32, CPU)
    for f in ('img', 'mask', 'known_sat', 'pool_train', 'pool_val',
              'shift1', 'shift2', 'real_pool'):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    for f in ('pool_train_n', 'pool_val_n', 'real_pool_n'):
        assert getattr(tc, f) == int(getattr(jc, f)), f
    # a centroid near the hole (some candidates invalid), near a border,
    # and in open texture
    cents = np.array([[50, 45], [20, 20], [100, 110], [60, 100]], np.int32)
    select = jax.jit(JS._real_from_lattice, static_argnums=(2, 3, 4, 5))
    for topk in (1, 3, 5):
        want = select(jc, jnp.asarray(cents), len(cents), 32, topk, 0.3)
        got = TS._real_from_lattice(tc, torch.as_tensor(cents), 32, topk,
                                    0.3)
        for g, w, name in zip(got, want, ('rgb', 'mask', 'weight', 'valid')):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f'{name} topk={topk}')


def test_sample_patches_branches_and_shapes():
    """The port's own draws: all three branches appear, shapes are fixed,
    weights are normalised where valid and 'same' reuses the fake patch."""
    img, mask, train, val = _scene()
    consts = TS.build_sampler_consts(img, mask, train, val,
                                     [[[20.0, 0.0], [0.0, 24.0]]], 32, CPU)
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(40):
        b = TS.sample_patches(gen, consts, 2, 32, 3, 0.3)
        assert b.fake_coords.shape == (2, 32, 32, 2)
        assert b.real_rgb.shape == (2, 3, 32, 32, 3)
        assert b.weight.shape == b.valid.shape == (2, 3)
        assert torch.all(b.weight[~b.valid] == 0)
        rows = b.valid.any(1)
        np.testing.assert_allclose(b.weight.sum(1)[rows].numpy(), 1.0,
                                   atol=1e-6)
        if b.source == TS.SOURCE_SAME:
            assert torch.equal(b.real_rgb[:, 0], b.fake_rgb)
            assert not b.valid[:, 1:].any()
        seen.add(b.source)
    assert seen == {TS.SOURCE_VAL, TS.SOURCE_TRAIN, TS.SOURCE_SAME}


# eight seeded draws of draw_batch on _scene(): (branch, the fake patches'
# top-left corners, the pixel indices' sum and first three), and a digest
# of every index, patch and mask they drew
DRAWS_GOLDEN = [
    (1, [[43, 8], [82, 11]], 267916, [5660, 5333, 8205]),
    (2, [[86, 84], [3, 101]], 257841, [4295, 4343, 2259]),
    (2, [[7, 28], [10, 91]], 271742, [3144, 5987, 732]),
    (2, [[46, 98], [15, 89]], 247735, [5950, 2449, 2932]),
    (0, [[30, 62], [32, 47]], 259120, [5151, 5274, 4718]),
    (0, [[38, 45], [41, 35]], 245582, [3603, 6431, 4365]),
    (1, [[81, 79], [1, 34]], 272315, [896, 2469, 1110]),
    (0, [[31, 51], [39, 35]], 296225, [6372, 7131, 1513]),
]
DRAWS_DIGEST = \
    'ad7122f193a83414f86bb416dbb05d595db0cb0548a517ee922e0ae0ae91b046'


def test_seeded_draws_match_their_golden():
    """The fit's draws (the patches, then N_rand pixel indices) from one
    seeded generator, with the copies to the device in between: the same
    values, in the same order, as the golden taken before the copies were
    staged through pinned memory. A seed above 2**31 as the benchmark's."""
    img, mask, train, val = _scene()
    consts = TS.build_sampler_consts(img, mask, train, val,
                                     [[[20.0, 0.0], [0.0, 24.0]]], 32, CPU)
    cfg = types.SimpleNamespace(N_rand=64, num_real_patch_per_sample=3,
                                invalid_ratio=0.3, no_reg_sampling=False)
    gen = torch.Generator().manual_seed(2 ** 31 + 7)
    digest = hashlib.sha256()
    for source, corners, pix_sum, pix_head in DRAWS_GOLDEN:
        b, pix = draw_batch(cfg, gen, consts, consts.pool_train_n, 2, 32)
        assert (b.source, b.fake_coords[:, 0, 0].tolist(), int(pix.sum()),
                pix[:3].tolist()) == (source, corners, pix_sum, pix_head)
        for t in (pix, b.fake_coords, b.fake_rgb, b.fake_mask, b.real_rgb,
                  b.real_mask, b.valid):
            digest.update(t.contiguous().numpy().tobytes())
    assert digest.hexdigest() == DRAWS_DIGEST
