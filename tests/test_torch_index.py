"""Port parity: the int4 + bf16-shadow FlatIndex against the JAX package's.

The JAX index runs its accelerator branch (`_use_pallas` patched to True), so
its int4 scan is the K1 Pallas kernel and its batch >= 64 approx_rescore is
the fused K5 kernel, both in interpret mode; the port takes that structure on
every device. The JAX rotation and mean are carried over by the bridge."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import assert_ids_match, index_state

from intel_extension_for_transformers_tpu.ops import scan_topk as jst
from intel_extension_for_transformers_tpu.retrieval import index as jindex
from intel_extension_for_transformers_tpu.retrieval.synthetic import clustered_embeddings
from intel_extension_for_transformers_tpu_torch import bridge
from intel_extension_for_transformers_tpu_torch.retrieval import index as tindex

torch.set_num_threads(1)

N, D = 4096, 128
# Scores: the int4 scan is bf16 on both sides and the rescore is f32, summed
# in different orders: 1e-4 absolute on unit vectors. Ids compare as sets,
# except near-ties at the k-th score within the same bound.
TOL = 1e-4


@pytest.fixture(scope="module")
def corpus():
    return clustered_embeddings(N, D, n_queries=64, seed=0)


@pytest.fixture(scope="module")
def indexes(corpus):
    docs, _ = corpus
    mp = pytest.MonkeyPatch()
    mp.setattr(jindex, "_use_pallas", lambda: True)
    j = jindex.FlatIndex(D, "int4", rescore_dtype="bfloat16", capacity=N)
    j.add(docs)
    meta, arrays = index_state(j)
    yield j, bridge.flat_index_state(meta, arrays, device="cpu"), mp
    mp.undo()


@pytest.mark.parametrize("method", ["exact", "approx_rescore"])
def test_int4_two_tier_search_matches(corpus, indexes, method):
    """B = 16 < 64: the int4 scan (K1) + exact shadow rescore on both sides."""
    _, queries = corpus
    j, t, _ = indexes
    js, ji = j.search(queries[:16], k=10, method=method, oversample=32)
    ts, ti = t.search(queries[:16], k=10, method=method, oversample=32)
    np.testing.assert_allclose(ts, js, rtol=0, atol=TOL)
    assert_ids_match(ti, ts, ji, js, TOL)


def test_int4_scan_scores_match(corpus, indexes):
    """The (B, N) int4 scan itself, bf16 out, mean correction added back."""
    _, queries = corpus
    j, t, _ = indexes
    q = queries[:8] @ np.asarray(j._rotation)
    want = jindex._int4_scores(
        jnp.asarray(q), j._data, j._scales, None, None, j._mean, 64, True,
        out_dtype=jnp.bfloat16,
    )
    got = tindex._int4_scores(
        torch.from_numpy(q), t._data, t._scales, t._mean, 64, torch.bfloat16
    )
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=0, atol=1e-2
    )
    # bf16 output: scores near 1 are rounded to 2^-8 steps; agreement is to
    # the rounding of the same f32 value, so most entries are equal
    assert (got.float().numpy() == np.asarray(want.astype(jnp.float32))).mean() > 0.99


def test_fused_scan_search_matches(corpus, indexes):
    """B = 64 approx_rescore: the fused scan+top-2 (K5) over the shadow."""
    _, queries = corpus
    j, t, _ = indexes
    js, ji = j.search(queries, k=10, method="approx_rescore", oversample=32)
    ts, ti = t.search(queries, k=10, method="approx_rescore", oversample=32)
    np.testing.assert_allclose(ts, js, rtol=0, atol=TOL)
    assert_ids_match(ti, ts, ji, js, TOL)
    # and it is the JAX package's scan_topk_candidates over the shadow
    qrot = jnp.asarray(queries) @ j._rotation
    cv, _ = jst.scan_topk_candidates(qrot, j._shadow, N, 32, interpret=True)
    np.testing.assert_allclose(ts, np.asarray(cv)[:, :10], rtol=0, atol=TOL)


def test_add_with_jax_rotation_reproduces_codes(corpus, indexes, monkeypatch):
    """The port's own encode, given the JAX rotation, writes the JAX codes:
    at most a few nibbles differ, where the two mean computations round a
    residual across a quantization boundary."""
    docs, _ = corpus
    j, _, _ = indexes
    monkeypatch.setattr(tindex, "random_rotation", lambda dim, seed=0: torch.from_numpy(np.array(j._rotation)))
    t = tindex.FlatIndex(D, "int4", rescore_dtype="bfloat16", capacity=N, device="cpu")
    t.add(docs)
    np.testing.assert_allclose(t._mean.numpy(), np.asarray(j._mean), rtol=0, atol=1e-6)
    assert (t._data.numpy() == np.asarray(j._data)).mean() > 0.999
    np.testing.assert_array_equal(
        t._shadow.float().numpy(), np.asarray(j._shadow.astype(jnp.float32))
    )


def test_save_load_round_trip(corpus, indexes, tmp_path):
    _, queries = corpus
    j, t, _ = indexes
    t.save(str(tmp_path / "port"))
    back = tindex.FlatIndex.load(str(tmp_path / "port"), device="cpu")
    a = t.search(queries[:4], k=5)
    b = back.search(queries[:4], k=5)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])
    # the JAX package reads the port's files (it ignores `rotation`) ...
    jback = jindex.FlatIndex.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(jback._data[:, :N]), t._data.numpy())
    # ... and the port reads the JAX package's only with the rotation supplied
    j.save(str(tmp_path / "jax"))
    with pytest.raises(ValueError, match="rotation"):
        tindex.FlatIndex.load(str(tmp_path / "jax"), device="cpu")
    again = tindex.FlatIndex.load(str(tmp_path / "jax"), rotation=np.asarray(j._rotation), device="cpu")
    np.testing.assert_array_equal(again.search(queries[:4], k=5)[1], a[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_float_index_exact_search_matches(corpus, dtype):
    """Tolerance: 1e-5 absolute on scores (f32 storage is full f32; bf16 is
    bf16 products with f32 sums on both sides)."""
    docs, queries = corpus
    j = jindex.FlatIndex(D, dtype)
    j.add(docs[:1000])
    t = tindex.FlatIndex(D, dtype, device="cpu")
    t.add(docs[:1000])
    js, ji = j.search(queries[:8], k=10)
    ts, ti = t.search(queries[:8], k=10)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    assert_ids_match(ti, ts, ji, js, 1e-5)
