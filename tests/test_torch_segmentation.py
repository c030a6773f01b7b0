"""Port parity on the CPU for the segmentation's coarse mask: the colour
conversion and SLIC (on torch's CPU here, on the card in chip_smoke.py),
the superpixel statistics and edges, the graph cut, the scaler and GMM
against sklearn, the coarse period mask and the loader against
`npp_tpu`, on the images of tests/test_segmentation.py and a 128x160
copy of scripts/eval_segmentation_iou.py's synthetic example."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn import cluster, preprocessing
from sklearn.utils import check_random_state

from npp_tpu.config import SegmentationConfig as JaxSegConfig
from npp_tpu.segmentation import coarse as JC
from npp_tpu.segmentation import features as JF
from npp_tpu.segmentation import graphcut as JG
from npp_tpu.segmentation import slic as JS
from npp_tpu_torch import config as TC
from npp_tpu_torch.models.loaders import segmentation_data
from npp_tpu_torch.segmentation import coarse as TCo
from npp_tpu_torch.segmentation import features as TF
from npp_tpu_torch.segmentation import graphcut as TG
from npp_tpu_torch.segmentation import slic as TS
from npp_tpu_torch.utils.synthetic import synthetic_segment_data
from tests.torch_threads import few_threads  # noqa: F401  (autouse)


def _two_tone_slic():
    rng = np.random.RandomState(0)
    img = rng.rand(60, 80, 3) * 0.1
    img[:, 40:] += 0.8
    return img, dict(sp_size=15, relative_compact=0.2)


def _masked_slic():
    rng = np.random.RandomState(0)
    img = rng.rand(50, 50, 3)
    mask = np.zeros((50, 50), bool)
    mask[10:40, 10:40] = True
    return img, dict(sp_size=10, relative_compact=0.2, mask=mask)


def _two_tone_coarse():
    rng = np.random.RandomState(0)
    img = rng.rand(80, 100, 3) * 0.2 * 255
    img[:, 50:] += 0.7 * 255
    return np.uint8(img), dict(nb_classes=2, sp_size=15, sp_regul=0.2)


def _synth_u8():
    """scripts/eval_segmentation_iou.py::synth_example(0, 128, 160), through
    the port's copy (test_synthetic_example_is_the_scripts)."""
    return np.uint8(synthetic_segment_data(0, 128, 160)['gt_img'] * 255)


def test_synthetic_example_is_the_scripts():
    """utils/synthetic.py's copy gives the script's image and mask bit for
    bit, and lattices whose patch size is 64."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..',
                                    'scripts'))
    from eval_segmentation_iou import synth_example
    from npp_tpu_torch.utils.io import patch_size_from_periods
    for seed in (0, 1):
        img, gt = synth_example(seed)
        d = synthetic_segment_data(seed)
        np.testing.assert_array_equal(d['gt_img'], img)
        np.testing.assert_array_equal(d['gt_mask'], gt)
        assert patch_size_from_periods(d['selected_periods']) == 64


def test_rgb2lab_matches_jax():
    """Within 1e-5 of the largest magnitude (L reaches 100): f32 on both
    sides, pow(t, 1/3) against XLA's cbrt and the 3x3 colour matrix as
    products and sums against a matmul differ in the last ulp."""
    rgb = np.random.RandomState(0).rand(20, 30, 3)
    rgb[0, :3] = [[1, 1, 1], [0, 0, 0], [1, 0, 0]]
    want = np.asarray(JS.rgb2lab(jnp.asarray(rgb)))
    got = TS.rgb2lab(torch.tensor(rgb, dtype=torch.float32)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_gauss_presmoothing_matches_jax():
    """The sigma=1 reflect-padded blur: rtol 1e-6 of the largest value."""
    x = np.random.RandomState(1).rand(17, 23).astype(np.float32) * 100
    want = np.asarray(JS._gauss(jnp.asarray(x)))
    got = TS._gauss(torch.tensor(x)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize('case', [_two_tone_slic, _masked_slic])
def test_slic_labels_equal_jax(case):
    """tests/test_segmentation.py's SLIC images: every label equal."""
    img, kw = case()
    np.testing.assert_array_equal(TS.slic_segment(img, **kw),
                                  JS.slic_segment(img, **kw))


def test_slic_on_synthetic_example_matches_jax():
    """The 128x160 synthetic example at the loader's sp_size 20 and
    regularisation 0.1: at most 0.1% of the labels differ (ties of the f32
    distances may fall either way)."""
    img = _synth_u8()
    got = TS.slic_segment(img, sp_size=20, relative_compact=0.1)
    want = JS.slic_segment(img, sp_size=20, relative_compact=0.1)
    assert (got != want).mean() <= 1e-3


def test_superpixel_stats_and_edges_equal_jax():
    img = _synth_u8()
    seg = JS.slic_segment(img, sp_size=20, relative_compact=0.1)
    np.testing.assert_array_equal(TF.superpixel_color_stats(img, seg),
                                  JF.superpixel_color_stats(img, seg))
    np.testing.assert_array_equal(TF.superpixel_centers(seg),
                                  JF.superpixel_centers(seg))
    np.testing.assert_array_equal(TF.segment_adjacency_edges(seg),
                                  JF.segment_adjacency_edges(seg))


@pytest.mark.parametrize('seed', range(6))
def test_graph_cut_bit_equal_jax(seed):
    """tests/test_graphcut.py's random graphs: the same labels and the same
    energy, bit for bit (one C++ source, two builds)."""
    rng = np.random.RandomState(seed)
    n, k = 8, 3
    edges = np.array([(i, j) for i in range(n) for j in range(i + 1, n)
                      if rng.rand() < 0.4], np.int32)
    if len(edges) == 0:
        edges = np.array([[0, 1]], np.int32)
    w = rng.rand(len(edges)) * 2
    unary = rng.rand(n, k) * 3
    pw = (np.full((k, k), 1.0) - np.eye(k)) * rng.uniform(0.5, 2.0)
    got = TG.cut_general_graph(edges, w, unary, pw)
    want = JG.cut_general_graph(edges, w, unary, pw)
    np.testing.assert_array_equal(got, want)
    assert TG.labeling_energy(edges, w, unary, pw, got) == \
        JG.labeling_energy(edges, w, unary, pw, want)


def _sklearn_resps(x, k, seed=0, n_init=9):
    """The starting responsibilities sklearn's GaussianMixture(n_init=9,
    random_state=seed) draws: one k-means per run on one RandomState."""
    rs = check_random_state(seed)
    out = []
    for _ in range(n_init):
        lab = cluster.KMeans(n_clusters=k, n_init=1,
                             random_state=rs).fit(x).labels_
        r = np.zeros((len(x), k))
        r[np.arange(len(x)), lab] = 1.0
        out.append(r)
    return out


@pytest.mark.parametrize('case', [_two_tone_coarse, 'synth'])
def test_gmm_from_sklearns_start_matches_sklearn(case):
    """The scaler exactly; given sklearn's starting responsibilities, the
    EM's means and covariances within 1e-6 of sklearn's largest magnitude,
    the same lower bound (rtol 1e-9) and the same labels."""
    if case == 'synth':
        img, kw = _synth_u8(), dict(nb_classes=3, sp_size=20, sp_regul=0.1)
    else:
        img, kw = case()
    _, feats = TCo.compute_superpixels_features(img, kw['sp_size'],
                                                kw['sp_regul'], None)
    fv = feats[1:]
    sk = JC.estim_class_model(fv, kw['nb_classes'])
    gm = sk.named_steps['gmm']
    x_sk = preprocessing.StandardScaler().fit_transform(fv)
    x, g = TCo.estim_class_model(fv, kw['nb_classes'],
                                 init_resps=_sklearn_resps(x_sk,
                                                           kw['nb_classes']))
    np.testing.assert_array_equal(x, x_sk)
    for got, want in ((g.means, gm.means_), (g.covariances, gm.covariances_),
                      (g.weights, gm.weights_)):
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(g.lower_bound, gm.lower_bound_, rtol=1e-9)
    np.testing.assert_array_equal(g.predict_proba(x).argmax(1),
                                  sk.predict(fv))


@pytest.mark.parametrize('case', [_two_tone_coarse, 'synth'])
def test_kmeans_start_equals_sklearns(case):
    """The port's k-means start repeats sklearn's steps and draws: each of
    the nine runs on one RandomState(0) gives sklearn's labels."""
    if case == 'synth':
        img, kw = _synth_u8(), dict(nb_classes=3, sp_size=20, sp_regul=0.1)
    else:
        img, kw = case()
    _, feats = TCo.compute_superpixels_features(img, kw['sp_size'],
                                                kw['sp_regul'], None)
    x = preprocessing.StandardScaler().fit_transform(feats[1:])
    rng = np.random.RandomState(0)
    for want in _sklearn_resps(x, kw['nb_classes']):
        np.testing.assert_array_equal(
            TCo.kmeans_responsibilities(x, kw['nb_classes'], rng), want)


def _period_mask(seg, nb):
    """The loader's period label: the class holding most of the centre
    quarter (independent of the component order)."""
    seg = np.uint8(seg + 1)
    h, w = seg.shape
    counts = np.bincount(seg[h // 4: h // 4 * 3, w // 4: w // 4 * 3].ravel(),
                         minlength=nb + 1)[1:]
    return seg == counts.argmax() + 1


@pytest.mark.parametrize('case', [_two_tone_coarse, 'synth'])
def test_coarse_period_mask_equals_jax(case):
    """The port's own k-means start (not sklearn's): the coarse period
    mask equals npp_tpu's pixel for pixel."""
    if case == 'synth':
        img, kw = _synth_u8(), dict(nb_classes=3, sp_size=20, sp_regul=0.1)
    else:
        img, kw = case()
    mask = np.ones(img.shape[:2], bool)
    got = TCo.coarse_segment(img, mask, **kw)
    want = JC.coarse_segment(img, mask, **kw)
    np.testing.assert_array_equal(_period_mask(got, kw['nb_classes']),
                                  _period_mask(want, kw['nb_classes']))


def test_segmentation_loader_matches_jax_on_arrays(tmp_path):
    """segmentation_data on the 128x160 example against npp_tpu's
    load_segmentation on the same arrays (its PNG reads patched out): the
    blurred image (rtol 1e-12), the period and non-period masks, the pixel
    pools and the lattices equal."""
    from npp_tpu.models import loaders as JL
    arrays = synthetic_segment_data(0, 128, 160)
    img = np.uint8(arrays['gt_img'] * 255) / 255.0
    arrays = dict(arrays, gt_img=img)
    cfg = TC.SegmentationConfig()
    got = segmentation_data(arrays, cfg, torch.device('cpu'))
    rec = {k: arrays[k] for k in ('selected_shifts', 'selected_angles',
                                  'selected_periods')}
    rec.update(fpath_gt_img='gt', fpath_valid_mask='valid')
    orig = (JL.read_odgt, JL.read_rgb, JL.read_gray)
    try:
        JL.read_odgt = lambda d: rec
        JL.read_rgb = lambda p: img
        JL.read_gray = lambda p: arrays['valid_mask']
        want = JL.load_segmentation(JaxSegConfig())
    finally:
        JL.read_odgt, JL.read_rgb, JL.read_gray = orig
    np.testing.assert_allclose(got.masked_img, want.masked_img, rtol=1e-12)
    for k in ('period_mask', 'non_period_mask'):
        np.testing.assert_array_equal(got.extra[k], want.extra[k], err_msg=k)
    np.testing.assert_array_equal(got.i_train, want.i_train)
    np.testing.assert_array_equal(got.i_val, want.i_val)
    assert got.patch_size == want.patch_size == 64
    assert got.selected_periods == want.selected_periods
    assert got.img.shape == want.img.shape == (128, 192, 3)


def test_run_segmentation_raises_without_a_card(monkeypatch):
    from npp_tpu_torch.models.segmentation import run_segmentation
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        run_segmentation(TC.SegmentationConfig(), save=False,
                         data=synthetic_segment_data(0, 64, 80))
