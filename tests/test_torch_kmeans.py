"""Port parity: `retrieval/_kmeans.py` against the JAX package's.

Inputs come from numpy seeds and go to both packages. Distances are f32 sums
in another order on each side, so they agree to ~1e-6 relative. On
well-separated data (clusters ~10 apart, each spread 0.5 wide, so no point
lies within that rounding of a boundary between two centroids) assignments,
counts and ranks are equal and centroids agree to 1e-5 absolute after each
Lloyd step (means of ~100 rows of magnitude ~3). Tight blobs are not enough:
where two starting centroids share a blob of spread 0.05, points crowd the
boundary between them and the two packages' roundings split them
differently.
The random picks use `np.random.default_rng` on both sides, so both start
from the same rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intel_extension_for_transformers_tpu.retrieval import _kmeans as jk
from intel_extension_for_transformers_tpu_torch.retrieval import _kmeans as tk

torch.set_num_threads(1)

TOL = 1e-5


def _blobs(n_centers=12, per=60, dim=16, seed=0, spread=0.5, uneven=False):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, dim)).astype(np.float32) * 3.0
    sizes = [per * (1 + 6 * (i == 0)) if uneven else per for i in range(n_centers)]
    x = np.concatenate([c + spread * rng.normal(size=(s, dim)) for c, s in zip(centers, sizes)])
    return x[rng.permutation(len(x))].astype(np.float32), centers


def _t(x):
    return torch.from_numpy(np.array(x))


def test_nearest_centroid_matches():
    x, centers = _blobs()
    cent = centers + 0.1
    want = np.asarray(jk._nearest_centroid(jnp.asarray(x), jnp.asarray(cent)))
    got = tk._nearest_centroid(_t(x), _t(cent)).numpy()
    np.testing.assert_array_equal(got, want)
    # and the distances behind them agree to f32 rounding
    jd = np.asarray(jnp.sum(x**2, 1, keepdims=True) - 2.0 * x @ cent.T + jnp.sum(cent**2, 1)[None])
    np.testing.assert_allclose(tk._sq_dists(_t(x), _t(cent)).numpy(), jd, rtol=1e-5, atol=1e-4)


def test_update_centroids_matches():
    x, centers = _blobs()
    C = 14  # two clusters stay empty and keep their previous centroid
    prev = np.concatenate([centers, np.ones((2, centers.shape[1]), np.float32)])
    assign = np.asarray(jk._nearest_centroid(jnp.asarray(x), jnp.asarray(prev)))
    want = np.asarray(jk._update_centroids(jnp.asarray(x), jnp.asarray(assign), C, jnp.asarray(prev)))
    got = tk._update_centroids(_t(x), _t(assign).long(), C, _t(prev)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got[-2:], prev[-2:])


def test_update_centroids_blocks_of_rows_sum_the_same(monkeypatch):
    """The one-hot product in blocks of rows gives the same means as one block."""
    x, centers = _blobs()
    assign = tk._nearest_centroid(_t(x), _t(centers))
    whole = tk._update_centroids(_t(x), assign, 12, _t(centers))
    monkeypatch.setattr(tk, "_ONE_HOT_ELEMENTS", 12 * 7)  # 7 rows a block
    np.testing.assert_allclose(tk._update_centroids(_t(x), assign, 12, _t(centers)).numpy(),
                               whole.numpy(), rtol=0, atol=TOL)


def test_cluster_counts_and_rank_in_group_are_exact():
    a = np.random.default_rng(3).integers(0, 9, size=500).astype(np.int32)
    np.testing.assert_array_equal(tk._cluster_counts(_t(a).long(), 11).numpy(),
                                  np.asarray(jk._cluster_counts(jnp.asarray(a), 11)))
    np.testing.assert_array_equal(tk._rank_in_group(_t(a).long()).numpy(),
                                  np.asarray(jk._rank_in_group(jnp.asarray(a))))


@pytest.mark.parametrize("k", [1, 3, 8, 20])
def test_top_k_keeps_lax_order_on_ties(k):
    """Values descending, equal values by the lowest index: rows full of
    ties, and ties that straddle the k-th place."""
    rng = np.random.default_rng(k)
    x = rng.integers(0, 4, size=(40, 20)).astype(np.float32)
    x[:5] = 1.0  # all tied
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = tk._top_k(_t(x), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_assign_constrained_matches():
    x, centers = _blobs(uneven=True)
    cent = centers + 0.01
    n, C = x.shape[0], centers.shape[0]
    cap = int(np.ceil(1.1 * n / C))
    want = np.asarray(jk._assign_constrained(jnp.asarray(x), jnp.asarray(cent), cap, C))
    got = tk._assign_constrained(_t(x), _t(cent), cap, C).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.bincount(got, minlength=C).max() <= cap


@pytest.mark.parametrize("kw", [
    {},
    {"normalize": True},
    {"constrained": True},
    {"balance_ratio": 1.5},  # the split branch runs (the first cluster is 7x the others)
])
def test_kmeans_matches(kw):
    x, _ = _blobs(uneven=True)
    want = np.asarray(jk.kmeans(jnp.asarray(x), 12, iters=6, seed=5, **kw))
    got = tk.kmeans(_t(x), 12, iters=6, seed=5, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("n_clusters,l1", [(24, 4), (30, 0), (12, 12)])
def test_kmeans_hierarchical_matches(n_clusters, l1):
    x, _ = _blobs(n_centers=6, per=80, uneven=True)
    want = np.asarray(jk.kmeans_hierarchical(jnp.asarray(x), n_clusters, l1=l1, iters=5, seed=2))
    got = tk.kmeans_hierarchical(_t(x), n_clusters, l1=l1, iters=5, seed=2).numpy()
    assert got.shape == want.shape == (n_clusters, x.shape[1])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
