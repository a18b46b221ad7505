"""Port parity: the IVF index (`retrieval/ivf.py`) against the JAX package's.

Both packages get the same numpy inputs. Codecs, insert planning and the
stored tables after `add` (codes, scales, lo plane, row ids, fill, dropped
rows) must be bit-identical: the port trains its own quantizer (near-equal
to the JAX one), then takes the JAX centroids, so both insert against the
same ones. Searches run on a port index carried over from the JAX one by the
bridge, on both routes of each side: `use_kernel=None` (the materializing
search on the CPU) and `use_kernel=True` (the JAX Pallas kernels in
interpret mode, the port's plain K6/K7). Scores are f32 sums of bf16 (or
f32) products over D = 64 in another order: they agree to TOL = 1e-5 for
these unit vectors, and ids compare as sets except near-ties at the k-th
score within TOL."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import assert_ids_match, ivf_state

from intel_extension_for_transformers_tpu.retrieval import ivf as jivf
from intel_extension_for_transformers_tpu_torch import bridge
from intel_extension_for_transformers_tpu_torch.retrieval import ivf as tivf
from intel_extension_for_transformers_tpu_torch.retrieval.synthetic import clustered_embeddings

torch.set_num_threads(1)

D, GS, N_LISTS = 64, 32, 16
TOL = 1e-5

# (name, IVFIndex kwargs): every storage dtype, refine with padded and dense
# lo planes, growing and spilling lists (spill with dropped rows at cap 100)
CONFIGS = {
    "float32": dict(dtype="float32", list_cap=48),
    "bfloat16": dict(dtype="bfloat16", list_cap=48),
    "int8": dict(dtype="int8", list_cap=48),
    "int8_spill": dict(dtype="int8", list_cap=100, spill=True),
    "int4_spill": dict(dtype="int4", list_cap=200, spill=True),
    "refine": dict(dtype="int4", list_cap=48, refine="int8"),
    "refine_dense_spill": dict(dtype="int4", list_cap=100, spill=True, refine="int8",
                               refine_capacity=3000),
}


@pytest.fixture(scope="module")
def corpus():
    docs, queries = clustered_embeddings(3000, D, n_queries=8, n_topics=16, seed=0)
    return docs, queries


def _t(x):
    return torch.from_numpy(np.array(x))


def _build(name, corpus, metric="ip"):
    """→ (JAX index, port index built by its own train + add with the JAX centroids)."""
    docs, _ = corpus
    kw = dict(CONFIGS[name], group_size=GS, metric=metric)
    j = jivf.IVFIndex(D, N_LISTS, **kw)
    j.train(docs[:1000], iters=5, seed=0)
    t = tivf.IVFIndex(D, N_LISTS, device="cpu", **kw)
    t.train(docs[:1000], iters=5, seed=0)
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids), rtol=0, atol=1e-5)
    t.centroids = _t(j.centroids)
    for part in (docs[:1200], docs[1200:]):  # the second add grows (or spills) lists
        np.testing.assert_array_equal(t.add(part), j.add(part))
    return j, t


@pytest.fixture(scope="module")
def built(corpus):
    return {name: _build(name, corpus) for name in CONFIGS}


def test_encode_residual_is_bit_identical(corpus):
    docs, _ = corpus
    rng = np.random.default_rng(1)
    cent = (docs[rng.integers(0, len(docs), 256)] * 0.9).astype(np.float32)
    for bits in (4, 8):
        jc, js = jivf._encode_residual(jnp.asarray(docs[:256]), jnp.asarray(cent), GS, bits)
        tc, ts = tivf._encode_residual(_t(docs[:256]), _t(cent), GS, bits)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.float().numpy(), np.asarray(js.astype(jnp.float32)))


def test_split_codec_is_bit_identical(corpus):
    docs, _ = corpus
    rng = np.random.default_rng(2)
    v = rng.normal(size=(64, D)).astype(np.float32)
    cent = rng.normal(size=(64, D)).astype(np.float32) * 0.9
    jh, jl, js = jivf._encode_residual_split(jnp.asarray(v), jnp.asarray(cent), GS)
    th, tl, ts = tivf._encode_residual_split(_t(v), _t(cent), GS)
    for got, want in ((th, jh), (tl, jl)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ts.float().numpy(), np.asarray(js.astype(jnp.float32)))
    got = tivf._decode_split_exact(th, tl, ts, GS).float().numpy()
    np.testing.assert_array_equal(got, np.asarray(jivf._decode_split_exact(jh, jl, js, GS).astype(jnp.float32)))
    # and it is the int8 codec's decode, bit for bit
    c8, s8 = tivf._encode_residual(_t(v), _t(cent), GS, 8)
    np.testing.assert_array_equal(got, tivf._decode_residual(c8, s8, GS, 8).float().numpy())


def test_segment_rank_is_exact():
    a = np.random.default_rng(4).integers(0, 17, size=700).astype(np.int32)
    np.testing.assert_array_equal(tivf._segment_rank(_t(a).long()).numpy(),
                                  np.asarray(jivf._segment_rank(jnp.asarray(a))))


def _plan_inputs(corpus, C=N_LISTS):
    docs, _ = corpus
    cent = docs[np.random.default_rng(5).choice(len(docs), C, replace=False)]
    fill = np.random.default_rng(6).integers(0, 30, size=C).astype(np.int32)
    return docs[:1500], cent, fill


def test_plan_insert_is_exact(corpus):
    v, cent, fill = _plan_inputs(corpus)
    want = jivf._plan_insert(jnp.asarray(v), jnp.asarray(cent), jnp.asarray(fill))
    got = tivf._plan_insert(_t(v), _t(cent), _t(fill))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cap,C", [(40, N_LISTS), (120, N_LISTS), (500, 4)])
def test_plan_insert_capped_is_exact(corpus, cap, C):
    """assign, slot, fill and the dropped mask; cap 40 drops rows, C = 4
    probes fewer lists than the 8 spill rounds."""
    v, cent, fill = _plan_inputs(corpus, C)
    want = jivf._plan_insert_capped(jnp.asarray(v), jnp.asarray(cent), jnp.asarray(fill), jnp.int32(cap))
    got = tivf._plan_insert_capped(_t(v), _t(cent), _t(fill), cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if cap == 40:
        assert got[3].any()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stored_tables_are_bit_identical(built, name):
    j, t = built[name]
    assert t._list_cap == j._list_cap and t.size == j.size and t.dropped == j.dropped
    np.testing.assert_array_equal(t._row_ids.numpy(), np.asarray(j._row_ids))
    np.testing.assert_array_equal(t._fill.numpy(), np.asarray(j._fill))
    np.testing.assert_array_equal(t._storage.float().numpy(), np.asarray(j._storage.astype(jnp.float32)))
    for a, b in ((t._scales, j._scales), (t._lo, j._lo)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b.astype(jnp.float32)))
    assert t.memory_bytes() == j.memory_bytes()
    if CONFIGS[name].get("spill"):  # capped lists never grow; the 3000 rows overflow 16 x 128 slots
        assert t._list_cap == choose_cap(CONFIGS[name]["list_cap"])
        assert (t.dropped > 0) == (t._list_cap * N_LISTS < 3000)
    else:
        assert t._list_cap > CONFIGS[name]["list_cap"]  # the second add grew the lists


def choose_cap(cap):
    from intel_extension_for_transformers_tpu_torch.ops.ivf_scan import choose_blocking

    return choose_blocking(cap)[1]


def _assert_search_match(got, want):
    (ts, ti), (js, ji) = got, want
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
    fin = np.isfinite(js)
    np.testing.assert_allclose(ts[fin], js[fin], rtol=0, atol=TOL)
    assert_ids_match(ti, ts, ji, js, TOL)


SEARCHES = [
    ("float32", {}), ("bfloat16", {}), ("int8", {}), ("int8_spill", {}), ("int4_spill", {}),
    ("refine", {"rescore_t": 8}), ("refine", {"rescore_r": 24}),
    ("refine_dense_spill", {"rescore_t": 6}), ("refine_dense_spill", {"rescore_r": 32}),
]


@pytest.mark.parametrize("use_kernel", [None, True])
@pytest.mark.parametrize("name,kw", SEARCHES)
def test_search_matches(built, corpus, name, kw, use_kernel):
    """The port, carried over by the bridge, against the JAX index on the
    same route; float storage has one route only."""
    _, queries = corpus
    j, _ = built[name]
    t = bridge.ivf_index_state(*ivf_state(j), device="cpu")
    want = j.search(queries, k=10, nprobe=4, use_kernel=use_kernel, **kw)
    got = t.search(queries, k=10, nprobe=4, use_kernel=use_kernel, **kw)
    assert got[1].dtype == np.int32 and got[0].shape == (len(queries), 10)
    _assert_search_match(got, want)


@pytest.mark.parametrize("name", ["int8", "int4_spill", "refine"])
def test_kernel_route_matches_materializing_route(built, corpus, name):
    """The port's plain K6/K7 route against its own materializing decode."""
    _, queries = corpus
    _, t = built[name]
    kw = {"rescore_r": 40} if CONFIGS[name].get("refine") else {}
    _assert_search_match(t.search(queries, k=10, nprobe=5, use_kernel=True, **kw),
                         t.search(queries, k=10, nprobe=5, use_kernel=False, **kw))


def test_kernel_layout_after_grow_matches(corpus):
    """A grown coded index pads to the kernel blocking at its first kernel
    search, on both sides alike."""
    j, t = _build("int8", corpus)
    assert t._list_cap == j._list_cap
    j.search(corpus[1][:2], k=5, nprobe=2, use_kernel=True)
    t.search(corpus[1][:2], k=5, nprobe=2, use_kernel=True)
    assert t._list_cap == j._list_cap and t._l_blk == j._l_blk
    np.testing.assert_array_equal(t._storage.numpy(), np.asarray(j._storage))
    np.testing.assert_array_equal(t._row_ids.numpy(), np.asarray(j._row_ids))


@pytest.mark.parametrize("name", ["int8", "bfloat16"])
def test_cosine_metric_matches(corpus, name):
    docs, queries = corpus
    scaled = (corpus[0] * np.linspace(0.5, 2.0, len(docs))[:, None].astype(np.float32), queries * 3.0)
    j, t = _build(name, scaled, metric="cosine")
    np.testing.assert_array_equal(t._row_ids.numpy(), np.asarray(j._row_ids))
    _assert_search_match(t.search(scaled[1], k=10, nprobe=4), j.search(scaled[1], k=10, nprobe=4))


@pytest.mark.parametrize("name", ["bfloat16", "int8_spill", "refine_dense_spill"])
def test_save_load_across_packages(built, corpus, tmp_path, name):
    """A JAX-saved directory loads in the port and searches the same; the
    JAX package reads the port's save. Scales and bf16 storage are saved as
    f32, so no bf16 array meets npz."""
    _, queries = corpus
    j, t = built[name]
    j.save(str(tmp_path / "jax"))
    with np.load(tmp_path / "jax" / "ivf.npz") as npz:
        assert all(npz[key].dtype.kind in "fi" for key in npz.files)
    back = tivf.IVFIndex.load(str(tmp_path / "jax"), device="cpu")
    _assert_search_match(back.search(queries, k=10, nprobe=4), j.search(queries, k=10, nprobe=4))
    t.save(str(tmp_path / "port"))
    jback = jivf.IVFIndex.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(jback._row_ids), t._row_ids.numpy())
    np.testing.assert_array_equal(np.asarray(jback._storage.astype(jnp.float32)), t._storage.float().numpy())
    again = tivf.IVFIndex.load(str(tmp_path / "port"), device="cpu")
    a, b = again.search(queries, k=10, nprobe=4), t.search(queries, k=10, nprobe=4)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])


def test_single_query_and_errors(built, corpus):
    _, queries = corpus
    _, t = built["int8"]
    s, i = t.search(queries[0], k=5, nprobe=3)
    assert s.shape == i.shape == (5,)
    with pytest.raises(ValueError, match="train"):
        tivf.IVFIndex(D, device="cpu").add(queries)
    with pytest.raises(ValueError, match="empty"):
        empty = tivf.IVFIndex(D, 4, device="cpu")
        empty.train(corpus[0][:100], iters=2)
        empty.search(queries)
    with pytest.raises(ValueError, match="refine"):
        tivf.IVFIndex(D, dtype="int8", refine="int8", device="cpu")
    full = tivf.IVFIndex(D, 4, dtype="int4", refine="int8", refine_capacity=10, device="cpu")
    full.train(corpus[0][:100], iters=2)
    with pytest.raises(ValueError, match="dense refine plane full"):
        full.add(corpus[0][:20])
