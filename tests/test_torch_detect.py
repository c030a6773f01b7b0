"""Port parity on the CPU for periodicity detection: the OpenCV-free gray,
resize, blur and Canny of npp_tpu_torch/proposal/cv.py against OpenCV bit
for bit, the FFT loss grid against npp_tpu's, and the detected lattices
against npp_tpu's on the flagship image and a smaller one."""
import numpy as np
import pytest
import torch

from npp_tpu.proposal import features as JF
from npp_tpu.proposal import search_engine as JSE
from npp_tpu_torch.proposal import cv as TCV
from npp_tpu_torch.proposal import features as TF
from npp_tpu_torch.proposal import search_engine as TSE
from npp_tpu_torch.utils.synthetic import synthetic_search_data
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

cv2 = pytest.importorskip('cv2')

# (height, width): odd and even, the 64x80 activation size, and sizes that
# are not multiples of OpenCV's vector widths
SIZES = [(64, 80), (80, 64), (33, 47), (96, 128), (7, 5), (101, 131)]


def _images(seed, h, w):
    """A random uint8 RGB image and a smooth near-periodic one."""
    rng = np.random.RandomState(seed)
    noise = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    wave = 128 + 100 * np.sin(yy / rng.uniform(2, 9)) * \
        np.cos(xx / rng.uniform(2, 9))
    smooth = np.clip(wave[..., None] + rng.randn(h, w, 3) * 5, 0,
                     255).astype(np.uint8)
    return noise, smooth


def _cv2_canny(img):
    """cv2.Canny(img, 10, 100) as npp_tpu calls it (scalar dispatch)."""
    opt = cv2.useOptimized()
    cv2.setUseOptimized(False)
    try:
        return cv2.Canny(img, 10, 100)
    finally:
        cv2.setUseOptimized(opt)


@pytest.mark.parametrize('seed', range(3))
@pytest.mark.parametrize('h,w', SIZES)
def test_cv_replacements_equal_opencv_bit_for_bit(seed, h, w):
    """Gray, INTER_NEAREST on a float mask, INTER_LINEAR on uint8 (the
    detection's halvings and other sizes, up and down), the 3x3 Gaussian
    and Canny(10, 100): the same bits as OpenCV."""
    rng = np.random.RandomState(100 + seed)
    for img in _images(seed, h, w):
        gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        np.testing.assert_array_equal(TCV.rgb2gray(img), gray)
        sizes = [(max(w // 2, 1), max(h // 2, 1)),
                 (max(w // 4, 1), max(h // 4, 1)),
                 (int(rng.randint(1, 2 * w + 2)),
                  int(rng.randint(1, 2 * h + 2)))]
        mask = (rng.rand(h, w) > 0.3).astype(np.float64)
        for dsize in sizes:
            np.testing.assert_array_equal(TCV.resize_linear_u8(gray, dsize),
                                          cv2.resize(gray, dsize))
            np.testing.assert_array_equal(
                TCV.resize_nearest(mask, dsize),
                cv2.resize(mask, dsize, interpolation=cv2.INTER_NEAREST))
        blur = cv2.GaussianBlur(gray, (3, 3), 0)
        np.testing.assert_array_equal(TCV.gaussian_blur3(gray), blur)
        np.testing.assert_array_equal(TCV.canny(blur, 10, 100),
                                      _cv2_canny(blur))
        np.testing.assert_array_equal(TCV.canny(gray, 10, 100),
                                      _cv2_canny(gray))


def test_flagship_feature_stack_equals_npp_tpu():
    """The flagship image's gray, its activation channels and their edges:
    the port's feature stack equals npp_tpu's (OpenCV) exactly."""
    d = synthetic_search_data(0)
    img = np.uint8(d['masked_img'] * 255)
    mask = np.uint8(d['valid_mask'] * d['unknown_mask'])[..., 0]
    np.testing.assert_array_equal(TCV.rgb2gray(img),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
    act_t, m_t = TF.im2act(img, mask)
    act_j, m_j = JF.im2act(img, mask)
    np.testing.assert_array_equal(act_t, act_j)
    np.testing.assert_array_equal(m_t, m_j)
    for c in range(act_t.shape[0]):
        u8 = TF.normalize_to_uint8(act_t[c:c + 1])[0]
        np.testing.assert_array_equal(TCV.canny(TCV.gaussian_blur3(u8), 10,
                                                100),
                                      _cv2_canny(cv2.GaussianBlur(u8, (3, 3),
                                                                  0)))
    np.testing.assert_array_equal(TF.act2edge(act_t[:-1], m_t),
                                  JF.act2edge(act_j[:-1], m_j))


def test_alexnet_owt_conv1_matches_jax():
    """The owt AlexNet (conv1 padding 5, padded max-pools) on the same
    analytic weights as npp_tpu's, every tap: within 1e-4 relative to each
    tap's largest value (f32 convolutions in two libraries)."""
    import jax.numpy as jnp
    from npp_tpu.nn.features import AlexNetFeatures as JaxAlex
    from npp_tpu.nn.pretrained import load_tower_params as jax_params
    from npp_tpu_torch.nn.registry import get_feature_extractor
    x = np.random.RandomState(0).randn(2, 70, 90, 3).astype(np.float32)
    mod = JaxAlex(owt=True)
    want = mod.apply({'params': jax_params('alexnet_owt', mod,
                                           jnp.zeros((1, 64, 64, 3)))},
                     jnp.asarray(x))
    apply_fn, tap = get_feature_extractor('alexnet')
    assert tap == 'conv1'
    taps = ('conv1', 'relu1', 'relu2', 'relu3', 'relu4', 'relu5')
    got = apply_fn(torch.tensor(x), taps)
    for t in taps:
        w = np.asarray(want[t])
        assert got[t].shape == w.shape, t
        np.testing.assert_allclose(got[t].numpy(), w,
                                   atol=1e-4 * np.abs(w).max(), err_msg=t)


def test_registry_names():
    from npp_tpu.nn.registry import get_available_models as jax_names
    from npp_tpu_torch.nn.registry import (get_available_models,
                                           get_feature_extractor)
    assert get_available_models() == jax_names() == [
        'alexnet', 'alexnet_tv', 'vgg16', 'vgg19']
    x = torch.zeros(1, 64, 64, 3)
    for name, tap, ch in (('alexnet_tv', 'relu1', 64),
                          ('vgg16', 'relu3_3', 256),
                          ('vgg19', 'relu3_4', 256)):
        fn, t = get_feature_extractor(name)
        assert t == tap
        assert fn(x)[tap].shape[-1] == ch
    with pytest.raises(NotImplementedError):
        get_feature_extractor('resnet')


def _colour_image(seed, h, w):
    d = synthetic_search_data(seed, h, w)
    return (np.uint8(d['masked_img'] * 255),
            np.uint8(d['valid_mask'] * d['unknown_mask'])[..., 0])


@pytest.mark.parametrize('seed,size', [(1, (96, 128)), (2, (70, 90))])
def test_colour_feature_stack_matches_npp_tpu(seed, size):
    """im2act(gray_only=False): the 64 conv1 channels within 1e-4 of the
    largest (f32 convolutions), gray and mask equal; through act2edge's
    uint8 normalisation the edges then agree on all but 0.1% of pixels."""
    img, mask = _colour_image(seed, *size)
    act_t, m_t = TF.im2act(img, mask, gray_only=False)
    act_j, m_j = JF.im2act(img, mask, gray_only=False)
    assert act_t.shape == act_j.shape == (66,) + m_t.shape
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_array_equal(act_t[64:], act_j[64:])
    np.testing.assert_allclose(act_t[:64], act_j[:64],
                               atol=1e-4 * np.abs(act_j[:64]).max())
    e_t, e_j = TF.act2edge(act_t[:-1], m_t), JF.act2edge(act_j[:-1], m_j)
    assert np.mean(e_t != e_j) <= 1e-3


@pytest.mark.parametrize('seed', [1, 2])
def test_colour_detection_matches_npp_tpu(seed):
    """A colour search's candidates (the odgt's rank_candidates) equal
    npp_tpu's up to proven ties of the loss grid."""
    img, mask = _colour_image(seed, 96, 128)
    got = TSE.search_periodicity_by_feat(img, mask, repeat_range=(1, 10, 1),
                                         gray_only=False)
    want = JSE.search_periodicity_by_feat(img, mask, repeat_range=(1, 10, 1),
                                          gray_only=False)
    act, m = TF.im2act(img, mask, gray_only=False)
    act = act * TF.act2edge(act[:-1], m)[[0]]
    h, w = m.shape
    grid_t = TSE.displacement_loss_grid(torch.tensor(act[:-1]).float(),
                                        torch.tensor(m).float()).numpy()
    grid_j = np.asarray(JSE.displacement_loss_grid(
        act[:-1].astype(np.float32), m.astype(np.float32)))
    assert_same_up_to_ties(got, want, grid_t, grid_j, h, w)


@pytest.mark.parametrize('edge', [True, False])
def test_displacement_grid_matches_npp_tpu(edge):
    """torch.fft's grid against npp_tpu's jnp.fft grid, both f32: within
    1e-5 of the grid's largest magnitude (the two FFTs round
    differently)."""
    rng = np.random.RandomState(int(edge))
    act = rng.rand(2, 24, 32).astype(np.float32)
    mask = (rng.rand(24, 32) > 0.2).astype(np.float32)
    got = TSE.displacement_loss_grid(torch.tensor(act), torch.tensor(mask),
                                     edge).numpy()
    want = np.asarray(JSE.displacement_loss_grid(act, mask,
                                                 edge_searching=edge))
    assert got.shape == want.shape == (24, 64)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def assert_same_up_to_ties(got, want, grid_t, grid_j, h, w):
    """The same groups, angles and periods within 1e-6, and the same
    shifts, except where a differing shift's loss ties the other's within
    1e-5 of the grid's largest magnitude (the FFTs' rounding decides
    such ties)."""
    (a_t, p_t, s_t), (a_j, p_j, s_j) = got, want
    assert len(s_t) == len(s_j) > 0
    tol = 1e-5 * max(np.abs(grid_t).max(), np.abs(grid_j).max())
    for i in range(len(s_j)):
        if np.array_equal(np.asarray(s_t[i]), np.asarray(s_j[i])):
            np.testing.assert_allclose(a_t[i], a_j[i], rtol=0, atol=1e-6)
            np.testing.assert_allclose(p_t[i], p_j[i], rtol=0, atol=1e-6)
            continue
        for st, sj in zip(s_t[i], s_j[i]):
            if np.array_equal(st, sj):
                continue
            # detection reports shifts at full resolution; the grid is at
            # 1/4
            (xt, yt), (xj, yj) = (np.asarray(st) / 4).astype(int), \
                (np.asarray(sj) / 4).astype(int)
            for grid in (grid_t, grid_j):
                assert abs(grid[yt, xt + w] - grid[yj, xj + w]) <= tol, \
                    (i, st, sj)


@pytest.mark.parametrize('seed,size', [(0, (384, 512)), (1, (96, 128)),
                                       (2, (96, 128))])
def test_detection_matches_npp_tpu(seed, size):
    """search_periodicity_by_feat at the default SearchConfig on the
    flagship image and two seeds of a smaller one: npp_tpu's candidates."""
    d = synthetic_search_data(seed, *size)
    img = np.uint8(d['masked_img'] * 255)
    mask = np.uint8(d['valid_mask'] * d['unknown_mask'])[..., 0]
    got = TSE.search_periodicity_by_feat(img, mask, repeat_range=(1, 10, 1))
    want = JSE.search_periodicity_by_feat(img, mask, repeat_range=(1, 10, 1))
    act, m = TF.im2act(img, mask)
    act = act * TF.act2edge(act[:-1], m)[[0]]
    h, w = m.shape
    grid_t = TSE.displacement_loss_grid(torch.tensor(act[:-1]).float(),
                                        torch.tensor(m).float()).numpy()
    grid_j = np.asarray(JSE.displacement_loss_grid(
        act[:-1].astype(np.float32), m.astype(np.float32)))
    assert_same_up_to_ties(got, want, grid_t, grid_j, h, w)
    if seed == 0:
        assert len(got[0]) == 9
