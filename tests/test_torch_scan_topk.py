"""Port parity: the fused scan + per-tile top-2 against the JAX package's,
whose K5 Pallas kernel (_scan_top2_kernel) runs here in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intel_extension_for_transformers_tpu.ops import scan_topk as jst
from intel_extension_for_transformers_tpu_torch.ops import scan_topk as tst

torch.set_num_threads(1)

N, D, B, N_TILE = 4096, 128, 64, 256
# Scores are exact bf16 products summed in f32 on both sides; only the
# summation order differs, so values agree to 1e-5 absolute, and ids agree
# except where two candidates of a tile score within that of each other.
VAL_TOL = 1e-5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, D)).astype(np.float32)
    docs = rng.normal(size=(N, D)).astype(np.float32)
    # unit rows, as embeddings are: scores are O(1)
    return q / np.linalg.norm(q, axis=1, keepdims=True), docs / np.linalg.norm(
        docs, axis=1, keepdims=True
    )


def _run_both(q, docs, size):
    jv, ji = jst.scan_top2(
        jnp.asarray(q), jnp.asarray(docs).astype(jnp.bfloat16), size,
        n_tile=N_TILE, interpret=True,
    )
    tv, ti = tst.scan_top2(torch.from_numpy(q), torch.from_numpy(docs), size, n_tile=N_TILE)
    return np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()


def _assert_ids_equal_off_ties(jv, ji, ti):
    # a tile's top-2 may swap ids only where the two candidates near-tie;
    # compare per tile as sets, and exactly where the two scores are apart
    T = jv.shape[1] // 2
    pair_j = ji.reshape(B, T, 2)
    pair_t = ti.reshape(B, T, 2)
    pair_v = jv.reshape(B, T, 2)
    with np.errstate(invalid="ignore"):  # -inf - -inf in dead tiles
        apart = ~(np.abs(pair_v[..., 0] - pair_v[..., 1]) <= VAL_TOL)
    np.testing.assert_array_equal(pair_t[apart], pair_j[apart])
    assert (np.sort(pair_t, axis=2) == np.sort(pair_j, axis=2)).mean() > 0.99


@pytest.mark.parametrize("size", [N, 1000])
def test_scan_top2_matches_pallas_kernel(data, size):
    q, docs = data
    jv, ji, tv, ti = _run_both(q, docs, size)
    T = N // N_TILE
    assert tv.shape == ti.shape == (B, 2 * T)
    finite = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), finite)
    np.testing.assert_allclose(tv[finite], jv[finite], rtol=0, atol=VAL_TOL)
    _assert_ids_equal_off_ties(jv, ji, ti)
    assert ti.max() < size
    # tiles wholly past `size` give (-inf, -1)
    dead = np.arange(2 * T) // 2 * N_TILE >= size
    assert np.all(tv[:, dead] == -np.inf) and np.all(ti[:, dead] == -1)


def test_scan_top2_ties_go_to_highest_id():
    """Tolerance: none. Duplicate docs score equal; the later id wins."""
    rng = np.random.default_rng(2)
    docs = np.repeat(rng.normal(size=(8, D)).astype(np.float32), 2, axis=0)  # (16, D)
    q = rng.normal(size=(4, D)).astype(np.float32)
    tv, ti = tst.scan_top2(torch.from_numpy(q), torch.from_numpy(docs), 16, n_tile=16)
    jv, ji = jst.scan_top2(
        jnp.asarray(q), jnp.asarray(docs).astype(jnp.bfloat16), 16, n_tile=16, interpret=True
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert np.all(ti.numpy()[:, 0] % 2 == 1) and np.all(ti.numpy()[:, 1] == ti.numpy()[:, 0] - 1)


def test_scan_topk_candidates_matches(data):
    q, docs = data
    jv, ji = jst.scan_topk_candidates(
        jnp.asarray(q), jnp.asarray(docs).astype(jnp.bfloat16), N, 32,
        n_tile=N_TILE, interpret=True,
    )
    tv, ti = tst.scan_topk_candidates(torch.from_numpy(q), torch.from_numpy(docs), N, 32, n_tile=N_TILE)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=VAL_TOL)
    for rj, rt, vj in zip(np.asarray(ji), ti.numpy(), np.asarray(jv)):
        kth = vj.min()
        differ = set(rj.tolist()) ^ set(rt.tolist())
        # only candidates at the 32nd score may differ
        assert all(abs(vj[list(rj).index(i)] - kth) <= VAL_TOL for i in differ if i in rj)
