"""Coarse unsupervised segmentation: SLIC + colour stats + GMM + graph cut.

Port of `npp_tpu/segmentation/coarse.py` (the exercised path of the
vendored imsegm library; reference: NPP_segmentation/imsegm/pipelines.py:
114-250, graph_cuts.py:73-163,523-759). SLIC runs on the caller's device;
the rest on the host in float64. npp_tpu calls sklearn's StandardScaler
and full-covariance GaussianMixture, which the card's machine lacks: both
are written out here in numpy, following sklearn's arithmetic (the EM,
the 10 * eps mass floor, reg_covar on the diagonal, Cholesky precisions,
the best of n_init runs by lower bound). sklearn starts each run from its
own k-means: `kmeans_responsibilities` repeats its steps and its draws
from one numpy RandomState, but not its Cython's rounding, so near-ties
may fall otherwise; `gmm_em` takes the starting responsibilities from the
caller, so a test can hand it sklearn's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy.linalg import solve_triangular
from scipy.special import logsumexp

from .features import (segment_adjacency_edges, superpixel_centers,
                       superpixel_color_stats)
from .graphcut import cut_general_graph
from .slic import slic_segment

MIN_UNARY_PROB = 0.01       # reference: graph_cuts.py:36
MAX_PAIRWISE_COST = 1e5     # reference: graph_cuts.py:38
MIN_MAX_EDGE_WEIGHT = 1e3   # reference: graph_cuts.py:40
REG_COVAR = 1e-6            # sklearn GaussianMixture's default
GMM_TOL = 1e-3              # sklearn GaussianMixture's default


def compute_superpixels_features(image: np.ndarray, sp_size: int,
                                 sp_regul: float,
                                 mask: Optional[np.ndarray],
                                 device: Optional[torch.device] = None
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """reference: pipelines.py:253-278."""
    slic = slic_segment(image, sp_size=sp_size, relative_compact=sp_regul,
                        mask=mask, device=device)
    feats = superpixel_color_stats(image, slic,
                                   flags=('mean', 'median', 'meanGrad'))
    return slic, np.nan_to_num(feats)


def standard_scale(x: np.ndarray) -> np.ndarray:
    """sklearn's StandardScaler().fit_transform: per-column mean and
    population std; a column of (near) zero spread keeps scale 1."""
    x = np.asarray(x, np.float64)
    mean = x.mean(0)
    scale = x.std(0)
    scale = np.where(scale < 10 * np.finfo(np.float64).eps, 1.0, scale)
    return (x - mean) / scale


@dataclasses.dataclass
class GMM:
    """A full-covariance Gaussian mixture: weights (K,), means (K, D),
    covariances and Cholesky precisions (K, D, D)."""

    weights: np.ndarray
    means: np.ndarray
    covariances: np.ndarray
    precisions_cholesky: np.ndarray
    lower_bound: float = -np.inf

    def log_resp(self, x: np.ndarray) -> Tuple[float, np.ndarray]:
        """(mean log-likelihood, log responsibilities (N, K))."""
        n, d = x.shape
        log_prob = np.empty((n, len(self.means)))
        for k, (mu, pc) in enumerate(zip(self.means, self.precisions_cholesky)):
            y = x @ pc - mu @ pc
            log_prob[:, k] = np.sum(np.square(y), axis=1)
        log_det = np.sum(np.log(self.precisions_cholesky.reshape(
            len(self.means), -1)[:, ::d + 1]), axis=1)
        weighted = -0.5 * (d * np.log(2 * np.pi) + log_prob) + log_det + \
            np.log(self.weights)
        norm = logsumexp(weighted, axis=1)
        return float(np.mean(norm)), weighted - norm[:, None]

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        return np.exp(self.log_resp(x)[1])


def _gaussian_params(x: np.ndarray, resp: np.ndarray, reg_covar: float):
    nk = resp.sum(0) + 10 * np.finfo(resp.dtype).eps
    means = (resp.T @ x) / nk[:, None]
    d = x.shape[1]
    covs = np.empty((len(nk), d, d))
    prec = np.empty((len(nk), d, d))
    for k in range(len(nk)):
        diff = x - means[k]
        covs[k] = (resp[:, k] * diff.T) @ diff / nk[k]
        covs[k].flat[::d + 1] += reg_covar
        chol = np.linalg.cholesky(covs[k])
        prec[k] = solve_triangular(chol, np.eye(d), lower=True).T
    return nk, means, covs, prec


def gmm_em(x: np.ndarray, resp: np.ndarray, max_iter: int = 99,
           tol: float = GMM_TOL, reg_covar: float = REG_COVAR) -> GMM:
    """One EM run of sklearn's GaussianMixture(covariance_type='full')
    from the starting responsibilities `resp` (N, K)."""
    x = np.asarray(x, np.float64)
    nk, means, covs, prec = _gaussian_params(x, np.asarray(resp, np.float64),
                                             reg_covar)
    gmm = GMM(nk / len(x), means, covs, prec)
    lower = -np.inf
    for _ in range(max_iter):
        prev = lower
        lower, log_resp = gmm.log_resp(x)
        nk, means, covs, prec = _gaussian_params(x, np.exp(log_resp),
                                                 reg_covar)
        gmm = GMM(nk / nk.sum(), means, covs, prec)
        if abs(lower - prev) < tol:
            break
    gmm.lower_bound = lower
    return gmm


def _sq_dists(c: np.ndarray, x: np.ndarray, x_sq: np.ndarray) -> np.ndarray:
    """(m, n) squared distances as sklearn's _euclidean_distances forms
    them: -2 c.x + |c|^2 + |x|^2, clipped at 0."""
    d = -2 * (c @ x.T)
    d += np.einsum('ij,ij->i', c, c)[:, None]
    d += x_sq[None, :]
    return np.maximum(d, 0, out=d)


def kmeans_responsibilities(x: np.ndarray, k: int, rng: np.random.RandomState,
                            max_iter: int = 300, tol: float = 1e-4
                            ) -> np.ndarray:
    """One-hot (N, k) labels of one k-means run, the steps of sklearn's
    KMeans(n_clusters=k, n_init=1, random_state=rng).fit(x): the data
    centred, greedy k-means++ (2 + log k trials per centre, the same draws
    from `rng`), Lloyd iterations until the labels repeat or the centres
    move less than tol x the mean variance, then a last assignment. Ties
    and sums may round differently from sklearn's Cython."""
    x = np.asarray(x, np.float64)
    x = x - x.mean(0)
    n = len(x)
    x_sq = np.einsum('ij,ij->i', x, x)
    w = np.ones(n)
    trials = 2 + int(np.log(k))
    first = rng.choice(n, p=w / w.sum())
    centers = [x[first]]
    closest = _sq_dists(x[first][None], x, x_sq)
    pot = closest @ w
    for _ in range(1, k):
        cand = np.searchsorted(np.cumsum(w * closest),
                               rng.uniform(size=trials) * pot)
        np.clip(cand, None, closest.size - 1, out=cand)
        d = _sq_dists(x[cand], x, x_sq)
        np.minimum(closest, d, out=d)
        cand_pot = d @ w.reshape(-1, 1)
        best = np.argmin(cand_pot)
        pot, closest = cand_pot[best], d[best]
        centers.append(x[cand[best]])
    c = np.asarray(centers)
    tol = np.mean(np.var(x, axis=0)) * tol
    old = np.full(n, -1)
    strict = False
    for _ in range(max_iter):
        labels = np.argmin(_sq_dists(c, x, x_sq), 0)
        new = c.copy()
        for j in range(k):
            if np.any(labels == j):
                new[j] = x[labels == j].mean(0)
        shift = float(((new - c) ** 2).sum())
        c = new
        if np.array_equal(labels, old):
            strict = True
            break
        if shift <= tol:
            break
        old = labels
    if not strict:
        labels = np.argmin(_sq_dists(c, x, x_sq), 0)
    resp = np.zeros((n, k))
    resp[np.arange(n), labels] = 1.0
    return resp


def estim_class_model(features: np.ndarray, nb_classes: int,
                      max_iter: int = 99, seed: int = 0,
                      init_resps: Optional[List[np.ndarray]] = None
                      ) -> Tuple[np.ndarray, GMM]:
    """Scaler + full-covariance GMM (reference: graph_cuts.py:73-163 with
    model_type='GMM', use_scaler=True, pca_coef=None): n_init =
    int(sqrt(max_iter)) EM runs, the best by lower bound (the first of
    equals). init_resps: the runs' starting responsibilities (default:
    k-means under RandomState(seed)). Returns (scaled features, GMM)."""
    x = standard_scale(features)
    n_init = max(1, int(np.sqrt(max_iter)))
    if init_resps is None:
        rng = np.random.RandomState(seed)
        init_resps = [kmeans_responsibilities(x, nb_classes, rng)
                      for _ in range(n_init)]
    best = None
    for resp in init_resps:
        gmm = gmm_em(x, resp, max_iter=max_iter)
        if best is None or gmm.lower_bound > best.lower_bound:
            best = gmm
    return x, best


def compute_unary_cost(proba: np.ndarray,
                       min_prob: float = MIN_UNARY_PROB) -> np.ndarray:
    """reference: graph_cuts.py:523-540."""
    p = np.clip(proba, min_prob, 1.0 - min_prob)
    return np.abs(-np.log(p)).astype(np.float64)


def compute_pairwise_cost(gc_regul: float, nb_classes: int) -> np.ndarray:
    """Uniform Potts matrix (reference: graph_cuts.py:485-555)."""
    pw = gc_regul * (np.ones((nb_classes, nb_classes)) - np.eye(nb_classes))
    return np.minimum(pw, MAX_PAIRWISE_COST).astype(np.float64)


def compute_edge_weights(slic: np.ndarray, features: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """gc_edge_type='features' path (reference: graph_cuts.py:574-660):
    w = exp(-d_euclid(scaled feats) / (2 std(d)^2)) / relative spatial dist,
    clipped to [1e-3, 1e3]. Edges/labels are 0-based after dropping the
    masked-out label 0."""
    edges = segment_adjacency_edges(slic).astype(np.int32) - 1
    edges = edges[np.sum(edges < 0, axis=1) == 0]

    fnorm = standard_scale(features)
    d = np.linalg.norm(fnorm[edges[:, 0]] - fnorm[edges[:, 1]], axis=1)
    weights = np.exp(-(d / (2 * np.std(d) ** 2)))

    centres = superpixel_centers(slic)[1:]
    sp = np.linalg.norm(centres[edges[:, 0]] - centres[edges[:, 1]], axis=1)
    sp = sp / np.mean(sp)
    weights = weights / sp

    return edges, np.clip(weights, 1.0 / MIN_MAX_EDGE_WEIGHT,
                          MIN_MAX_EDGE_WEIGHT)


def coarse_segment(image: np.ndarray, mask: Optional[np.ndarray],
                   nb_classes: int = 3, sp_size: int = 20,
                   sp_regul: float = 0.1, gc_regul: float = 2.0,
                   seed: int = 0, device: Optional[torch.device] = None
                   ) -> np.ndarray:
    """Full unsupervised pipeline as the segmentation loader drives it
    (reference: loaders/loaders.py:163-179). Returns per-pixel class labels
    in [0, nb_classes); the caller shifts +1 and masks. SLIC runs on
    `device`."""
    slic, feats = compute_superpixels_features(image, sp_size, sp_regul, mask,
                                               device)
    feats_valid = feats[1:]
    x, model = estim_class_model(feats_valid, nb_classes, seed=seed)
    proba = model.predict_proba(x)

    edges, edge_weights = compute_edge_weights(slic, feats_valid)
    unary = compute_unary_cost(proba)
    pairwise = compute_pairwise_cost(gc_regul, proba.shape[1])
    if gc_regul <= 0 or len(edges) == 0:
        labels = np.argmin(unary, axis=-1).astype(np.int32)
    else:
        labels = cut_general_graph(edges, edge_weights, unary, pairwise)
    return labels[slic - 1]
