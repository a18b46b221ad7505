"""Port parity: K6 and K7's plain versions (`ops/ivf_scan.py`) against the JAX
package's Pallas kernels in interpret mode, on the same packed storage.

Storage is built as the JAX package's own kernel test builds it: residual
codes from `_encode_residual` placed in list order with empty slots, so some
rows of every list are empty (-1). Scores are f32 sums of bf16 products over
D = 128 in another order on each side: their gap is bounded by
D·2^-24·Σ|q_i·r_i| ≈ 1e-5 for these unit queries and residuals of norm ~3,
so scores agree to TOL = 1e-4 and ids compare as sets, except near-ties at
the k-th score within TOL."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import assert_ids_match

from intel_extension_for_transformers_tpu.ops import ivf_scan as jscan
from intel_extension_for_transformers_tpu.retrieval.ivf import _decode_residual, _encode_residual
from intel_extension_for_transformers_tpu.retrieval._kmeans import _nearest_centroid
from intel_extension_for_transformers_tpu_torch.ops import ivf_scan as tscan

torch.set_num_threads(1)

C, CAP, D, GS = 16, 40, 128, 32
TOL = 1e-4


def _storage(bits, seed=0):
    """→ (centroids, packed (C, L, W), scales (C, L, G) f32, row_ids (C, L), l_blk)."""
    rng = np.random.default_rng(seed)
    cent = rng.normal(size=(C, D)).astype(np.float32)
    v = (cent[rng.integers(0, C, C * 30)] * 0.9 + rng.normal(size=(C * 30, D)) * 0.3).astype(np.float32)
    assign = np.asarray(_nearest_centroid(jnp.asarray(v), jnp.asarray(cent)))
    l_blk, l_pad = jscan.choose_blocking(CAP, l_blk_max=256)
    W = D // 2 if bits == 4 else D
    packed = np.zeros((C, l_pad, W), np.int8)
    scales = np.zeros((C, l_pad, D // GS), np.float32)
    rids = np.full((C, l_pad), -1, np.int32)
    fill = np.zeros(C, np.int64)
    pk, sc = _encode_residual(jnp.asarray(v), jnp.asarray(cent[assign]), GS, bits)
    pk, sc = np.asarray(pk), np.asarray(sc.astype(jnp.float32))
    for i in range(len(v)):
        a = assign[i]
        if fill[a] >= CAP:
            continue
        packed[a, fill[a]], scales[a, fill[a]], rids[a, fill[a]] = pk[i], sc[i], i
        fill[a] += 1
    return cent, packed, scales, rids, l_blk


def _queries(B, nprobe, cent, seed=1, repeat=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    probes = np.argsort(-(q @ cent.T), axis=1)[:, :nprobe].astype(np.int32)
    if repeat:  # a query probing the same list twice (and one list shared by all)
        probes[:, -1] = probes[:, 0]
        probes[0, 1] = 3
    return q, probes


def _both(fn_j, fn_t, q, cent, packed, scales, rids, probes, **kw):
    want = fn_j(jnp.asarray(q), jnp.asarray(cent), jnp.asarray(packed),
                jnp.asarray(scales).astype(jnp.bfloat16), jnp.asarray(rids), jnp.asarray(probes),
                interpret=True, **kw)
    got = fn_t(torch.from_numpy(q), torch.from_numpy(cent), torch.from_numpy(packed),
               torch.from_numpy(scales).to(torch.bfloat16), torch.from_numpy(rids),
               torch.from_numpy(probes), **kw)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


def _assert_topk_match(want, got):
    (js, ji), (ts, ti) = want, got
    assert ts.shape == js.shape and ti.dtype == np.int32
    np.testing.assert_array_equal(np.isfinite(ts), np.isfinite(js))
    np.testing.assert_array_equal(ti < 0, ji < 0)
    fin = np.isfinite(js)
    np.testing.assert_allclose(ts[fin], js[fin], rtol=0, atol=TOL)
    assert_ids_match(ti, ts, ji, js, TOL)


def test_choose_blocking_matches():
    for cap in list(range(1, 3000, 7)) + [3663, 3840, 10_000, 400_000]:
        for kw in ({}, {"l_blk_max": 256}, {"l_blk_max": 512, "overhead_rows": 128}):
            assert tscan.choose_blocking(cap, **kw) == jscan.choose_blocking(cap, **kw), (cap, kw)


@pytest.mark.parametrize("bits,mult,offset", [(4, 1, 0), (8, 1, 0), (4, 16, 8)])
def test_decode_residual_is_bit_identical(bits, mult, offset):
    _, packed, scales, _, _ = _storage(bits)
    want = _decode_residual(jnp.asarray(packed), jnp.asarray(scales).astype(jnp.bfloat16), GS, bits,
                            mult, offset)
    got = tscan.decode_residual(torch.from_numpy(packed), torch.from_numpy(scales).to(torch.bfloat16),
                                GS, bits, mult, offset)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("bits,track,mult,offset", [
    (8, False, 1, 0),
    (4, False, 1, 0),
    (4, True, 16, 8),  # the refine tier's global top-r over the hi plane
    (8, True, 1, 0),
])
@pytest.mark.parametrize("B,nprobe,k,repeat", [(5, 4, 8, False), (3, 5, 24, True)])
def test_topk_plain_matches_pallas(bits, track, mult, offset, B, nprobe, k, repeat):
    cent, packed, scales, rids, l_blk = _storage(bits)
    q, probes = _queries(B, nprobe, cent, repeat=repeat)
    kw = dict(k=k, bits=bits, group_size=GS, l_blk=l_blk, track_positions=track,
              code_mult=mult, code_offset=offset)
    want, got = _both(jscan.ivf_scan_topk, tscan.ivf_scan_topk, q, cent, packed, scales, rids,
                      probes, **kw)
    _assert_topk_match(want, got)


def test_topk_plain_short_lists_pad_with_empty_slots():
    """k larger than the probed rows: the tail is (-inf, -1) on both sides."""
    cent, packed, scales, rids, l_blk = _storage(8)
    q, probes = _queries(2, 1, cent)
    want, got = _both(jscan.ivf_scan_topk, tscan.ivf_scan_topk, q, cent, packed, scales, rids, probes,
                      k=48, bits=8, group_size=GS, l_blk=l_blk)
    assert (got[1] == -1).any()
    _assert_topk_match(want, got)


@pytest.mark.parametrize("bits,mult,offset", [(4, 16, 8), (8, 1, 0), (4, 1, 0)])
@pytest.mark.parametrize("B,nprobe,t,repeat", [(5, 3, 6, False), (4, 4, 12, True)])
def test_candidates_plain_matches_pallas(bits, mult, offset, B, nprobe, t, repeat):
    cent, packed, scales, rids, l_blk = _storage(bits)
    q, probes = _queries(B, nprobe, cent, repeat=repeat)
    kw = dict(t=t, bits=bits, group_size=GS, l_blk=l_blk, code_mult=mult, code_offset=offset)
    (js, jp), (ts, tp) = _both(jscan.ivf_scan_candidates, tscan.ivf_scan_candidates, q, cent,
                               packed, scales, rids, probes, **kw)
    assert ts.shape == (B, nprobe * t)
    # each probe slot is its own top-t: compare slot by slot
    per_slot = [a.reshape(B * nprobe, t) for a in (js, jp, ts, tp)]
    _assert_topk_match(per_slot[:2], per_slot[2:])
    # positions lie in the probed list of their slot
    lists = np.where(tp >= 0, tp // packed.shape[1], -1).reshape(B, nprobe, t)
    assert np.all((lists == probes[:, :, None]) | (lists < 0))


def test_dispatch_runs_plain_only_on_cpu():
    cent, packed, scales, rids, l_blk = _storage(8)
    q, probes = _queries(2, 2, cent)
    args = [torch.from_numpy(a) for a in (q, cent, packed)] + [
        torch.from_numpy(scales).to(torch.bfloat16), torch.from_numpy(rids), torch.from_numpy(probes)]
    before = tscan.ivf_scan_topk_cuda.launches
    tscan.ivf_scan_topk(*args, k=4, bits=8, group_size=GS, l_blk=l_blk)
    assert tscan.ivf_scan_topk_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tscan.ivf_scan_topk_cuda(*args, k=4, bits=8, group_size=GS, l_blk=l_blk)
    with pytest.raises(ValueError, match="multiple of l_blk"):
        tscan.ivf_scan_topk(*args, k=4, bits=8, group_size=GS, l_blk=96)
