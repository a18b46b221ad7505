"""K6's and K7's design in plain Python (`ops/ivf_scan.py`): the bf16 steps
of their decode, their lane plan, their row ranges (and that K7's per-range
top-t, merged, is each slot's top-t), the codes they take, and that K7's
wrapper raises off the card.

The kernels (`csrc/ivf_scan_topk.cu`) run only on the card. Its decode is
emulated here step by step on 32-bit words, as the kernel does it: bit
operations for the exact bf16 integer, then `fma.rn.bf16x2`, whose product
and sum are exact and which rounds once to bf16 (emulated as f32 arithmetic,
exact at these widths, then one round to nearest even). It must give the bits
of `decode_residual` (the JAX package's decode, `test_torch_ivf_scan.py`) for
every code and every scale, normal, subnormal or large."""

import numpy as np
import pytest
import torch

from intel_extension_for_transformers_tpu_torch.ops import ivf_scan as tscan

ONE2 = 0x3F803F80  # bf16 pairs, as in csrc/common.cuh
NEG_ZERO2 = 0x80008000


def _f32(half):
    """16-bit bf16 patterns (int64) → their f32 values."""
    return (half.to(torch.int32) << 16).view(torch.float32)


def _fma(a, b, c):
    """One lane of fma.rn.bf16x2 on 16-bit patterns: exact, one rounding."""
    r = (_f32(a) * _f32(b) + _f32(c)).to(torch.bfloat16)
    return r.view(torch.int16).to(torch.int64) & 0xFFFF


def _fma2(a, b, c):
    """fma.rn.bf16x2 on 32-bit pairs (int64 tensors or ints), low half first."""
    a, b, c = (torch.as_tensor(v, dtype=torch.int64) for v in (a, b, c))
    return _fma(a & 0xFFFF, b & 0xFFFF, c & 0xFFFF) | (_fma(a >> 16, b >> 16, c >> 16) << 16)


def _perm(x, sel):
    """__byte_perm(x, 0x43434343, sel) for the two selectors the kernel uses."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [torch.full_like(x, 0x43)] * 4
    return sum(b[(sel >> (4 * i)) & 0xF] << (8 * i) for i in range(4))


def _pair_of(v: int) -> int:
    """A small integer as a bf16 pair (host side of itx_ivf_scan_topk)."""
    bits = int(np.float32(v).view(np.uint32)) >> 16
    return bits | (bits << 16)


# the column that each position of a 32-bit word's decode holds: int8 bytes
# 0 and 2, then 1 and 3; int4 low nibbles, then high ones (the kernel stages
# q in this order)
_DECODE_ORDER = {8: [0, 2, 1, 3], 4: [0, 2, 4, 6, 1, 3, 5, 7]}


def _kernel_decode(words, s, bits, mult, offset):
    """words (S, n) int64 32-bit code words, s (S, n, values a word) bf16
    scale patterns of each column → (S, n, values a word) bf16 patterns of
    the residual, in decode order. Each bf16 pair takes the scales of its two
    columns (one scale a word: all equal)."""
    order = _DECODE_ORDER[bits]
    sd = s[..., order]  # the scales in decode order
    pairs = []
    if bits == 8:
        vs = [_fma2((x & 0x007F007F) | 0x43004300, ONE2, (x & 0x00800080) | 0xC300C300) for x in (words, words >> 8)]
    else:
        t = (words & 0x0F0F0F0F) ^ 0x08080808
        u = ((words >> 4) & 0x0F0F0F0F) ^ 0x08080808
        vs = [_fma2(_perm(x, sel), ONE2, 0xC308C308) for x in (t, u) for sel in (0x4140, 0x4342)]
    for h, v in enumerate(vs):
        s2 = sd[..., 2 * h] | (sd[..., 2 * h + 1] << 16)
        ms = _fma2(_pair_of(mult), s2, NEG_ZERO2)
        os = _fma2(_pair_of(offset), s2, NEG_ZERO2) if offset else torch.full_like(ms, NEG_ZERO2)
        pairs.append(_fma2(v, ms, os))
    return torch.stack([h for p in pairs for h in (p & 0xFFFF, p >> 16)], dim=-1)


def _scales(kind, n=1024, seed=0):
    """n seeded positive bf16 scale patterns of one kind."""
    rng = np.random.default_rng(seed)
    lo, hi = {"normal": (107, 132), "subnormal": (0, 3), "large": (187, 237)}[kind]
    exp = rng.integers(lo, hi + 1, n)
    man = rng.integers(0, 128, n)
    man[(exp == 0) & (man == 0)] = 1  # no zero scale
    return torch.from_numpy((exp << 7) | man).to(torch.int64)


@pytest.mark.parametrize("per", ["word", "value"])
@pytest.mark.parametrize("kind", ["normal", "subnormal", "large"])
@pytest.mark.parametrize("bits,mult,offset", [(8, 1, 0), (4, 1, 0), (4, 16, 8)])
def test_kernel_decode_is_bit_identical(bits, mult, offset, kind, per):
    """Every int8 code, every signed nibble and every hi-plane value (16·hi
    + 8) times 1,024 scales, one a word (16-byte words) or one a value (a
    group smaller than a word): the kernel's bf16 steps give
    decode_residual's bits."""
    codes = torch.arange(256, dtype=torch.int64)  # every byte: every code or nibble pair
    S, D = 1024, 256 if bits == 8 else 512
    vals = 4 if bits == 8 else 8
    words = (codes.reshape(-1, 4) << torch.tensor([0, 8, 16, 24])).sum(1)  # little-endian 32-bit words
    if per == "word":
        s = _scales(kind, seed=bits * 100 + mult)
        s_cols, scales, g = s[:, None, None].expand(S, D // vals, vals), s[:, None], D
    else:
        s_cols = _scales(kind, n=S * D, seed=bits * 100 + mult + 1).reshape(S, D // vals, vals)
        scales, g = s_cols.reshape(S, D), 1
    got = _kernel_decode(words.expand(S, -1), s_cols, bits, mult, offset)  # (S, 64, 4 | 8)
    cols = torch.empty_like(got)
    cols[..., _DECODE_ORDER[bits]] = got  # decode position p holds column order[p] of its word
    packed = torch.where(codes >= 128, codes - 256, codes).to(torch.int8).expand(S, -1)
    want = tscan.decode_residual(packed, scales.to(torch.int16).view(torch.bfloat16), g, bits, mult, offset)
    want = want.view(torch.int16).to(torch.int64) & 0xFFFF
    assert torch.equal(cols.reshape(S, D), want)


def _check_plan_covers_every_column_once(D, bits, group_size, plan):
    """Word p·lanes·WPL + lane + lanes·j of each (pass p, lane, j), as the
    kernel reads them: each word of the row once, the masked ones past its
    end; with 16-byte words, each word inside one group."""
    lanes, per_lane, vpw = plan.lanes_per_row, plan.words_per_lane, plan.values_per_word
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32 and vpw == (128 if plan.wide else 32) // bits
    assert per_lane == tscan.K6_WORDS_PER_LANE[plan.wide] and plan.words * vpw == D
    read = [p * lanes * per_lane + lane + lanes * j
            for p in range(plan.passes) for lane in range(lanes) for j in range(per_lane)]
    words = [w for w in read if w < plan.words]
    assert sorted(words) == list(range(plan.words))  # each word once: each column once
    assert len(read) - len(words) < lanes * per_lane  # masked words only in the last pass
    assert sorted(c for w in words for c in range(w * vpw, (w + 1) * vpw)) == list(range(D))
    if plan.wide:  # one scale a word: the kernel's index w * vpw / g holds for all its columns
        for w in words:
            assert w * vpw // group_size == ((w + 1) * vpw - 1) // group_size


@pytest.mark.parametrize("group_size", [32, 64, 128])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("D", [64, 96, 128, 384, 768, 1024, 1536, 4096])
def test_k6_plan_covers_every_column_once(D, bits, group_size):
    if D % group_size:
        with pytest.raises(ValueError):
            tscan.k6_plan(D, bits, group_size)
        return
    plan = tscan.k6_plan(D, bits, group_size)
    assert plan.wide  # groups of whole 16-byte words
    _check_plan_covers_every_column_once(D, bits, group_size, plan)


@pytest.mark.parametrize("D,bits,group_size,aligned", [
    (768, 4, 16, True),  # a 16-byte word holds two groups
    (128, 8, 8, True),
    (768, 8, 48, True),  # three words a group: still wide
    (768, 8, 24, True),  # a word straddles two groups
    (100, 8, 4, True),  # rows of 25 4-byte words
    (200, 4, 2, True),
    (104, 4, 26, True),
    (768, 8, 32, False),  # storage that is not 16-byte aligned
    (8192, 4, 16, True),  # three passes
])
def test_k6_plan_takes_groups_smaller_than_a_word(D, bits, group_size, aligned):
    plan = tscan.k6_plan(D, bits, group_size, aligned)
    assert plan.wide == (aligned and D * bits % 128 == 0 and group_size % (128 // bits) == 0)
    _check_plan_covers_every_column_once(D, bits, group_size, plan)


@pytest.mark.parametrize("D,bits,group_size,why", [
    (6, 4, 2, "not whole 4-byte words"),
    (10, 8, 2, "not whole 4-byte words"),
    (768, 8, 7, "do not divide"),
    (768, 4, 0, "do not divide"),
    (768, 2, 32, "4- or 8-bit"),
    (768, 16, 32, "4- or 8-bit"),
])
def test_k6_plan_raises_for_shapes_the_kernel_cannot_take(D, bits, group_size, why):
    with pytest.raises(ValueError, match=why):
        tscan.k6_plan(D, bits, group_size)


@pytest.mark.parametrize("L,D,bits,group_size,want", [
    (256, 768, 8, 32, (1, 256)),
    (1536, 768, 8, 32, (1, 1536)),
    (2048, 768, 4, 32, (1, 2048)),
    (2049, 768, 8, 32, (2, 1025)),
    (3072, 768, 8, 32, (2, 1536)),
    (5000, 768, 4, 32, (3, 1667)),
    (1536, 4096, 8, 8, (2, 768)),  # q and its tables leave room for 1,109 rows in 48 KB
    (1536, 11264, 8, 32, (1, 1536)),  # q alone passes 48 KB: the opt-in budget
])
def test_k6_splits(L, D, bits, group_size, want):
    plan = tscan.k6_plan(D, bits, group_size)
    splits, rows = tscan.k6_splits(L, plan)
    assert (splits, rows) == want
    assert rows <= tscan.K6_MAX_SPLIT_ROWS and splits * rows >= L > (splits - 1) * rows
    assert tscan.k6_smem(plan, rows) <= (48 * 1024 if tscan.k6_smem(plan, min(L, 512)) <= 48 * 1024
                                         else tscan.K6_SMEM_OPTIN)


@pytest.mark.parametrize("bits,mult,offset,ok", [
    (8, 1, 0, True),
    (4, 1, 0, True),
    (4, 16, 8, True),  # the refine tier's hi plane
    (4, 3, 0, False),  # mult·s inexact
    (4, 16, 5, False),  # offset·s inexact
    (8, 4, 1, False),  # 4·127 + 1 is not a bf16
])
def test_k6_check_codes(bits, mult, offset, ok):
    if ok:
        tscan.k6_check_codes(bits, mult, offset)
    else:
        with pytest.raises(ValueError, match="inexactly"):
            tscan.k6_check_codes(bits, mult, offset)


def _slot_scores(L, D, bits, group_size, t, *, C=3, B=2, nprobe=4, seed=0):
    """Base-free scores and flat positions (B, nprobe, L) of random codes
    through the plain version's own scoring (`_list_scores`), each query
    probing its first list again at its last slot, a third of the slots
    empty; then ties planted at each slot's t-th score."""
    gen = torch.Generator().manual_seed(seed)
    W = D // 2 if bits == 4 else D
    packed = torch.randint(-128, 128, (C, L, W), generator=gen).to(torch.int8)
    scales = (torch.rand(C, L, D // group_size, generator=gen) * 0.02 + 0.01).to(torch.bfloat16)
    row_ids = torch.arange(C * L, dtype=torch.int32).reshape(C, L)
    row_ids[torch.rand(C, L, generator=gen) < 1 / 3] = -1
    q = torch.randn(B, D, generator=gen).to(torch.bfloat16).to(torch.float32)
    probes = torch.randint(0, C, (B, nprobe), generator=gen)
    probes[:, -1] = probes[:, 0]
    s, pos = tscan._list_scores(q, probes, packed, scales, row_ids, bits=bits, group_size=group_size,
                                code_mult=16 if bits == 4 else 1, code_offset=8 if bits == 4 else 0,
                                track_positions=True)
    kth = torch.sort(s, dim=-1, descending=True).values[..., t - 1 : t]
    tie = (torch.rand(C, L, generator=gen) < 0.01)[probes] & torch.isfinite(s)  # a repeat, its ties too
    return torch.where(tie, kth.expand_as(s), s), pos


@pytest.mark.parametrize("t", [1, 24, 250])
@pytest.mark.parametrize("L,D,bits,group_size,splits", [
    (4096, 768, 8, 32, 2),
    (5120, 768, 4, 32, 3),
    (1536, 4096, 8, 8, 2),  # q and its tables leave room for 1,109 rows a range
])
def test_range_topk_merged_is_the_slot_topk(L, D, bits, group_size, splits, t):
    """K7's row ranges (`k6_splits`): each range's top-t, merged as
    `itx_ivf_merge_topk` ranks them, is the slot's top-t, bit for bit, with
    ties at the t-th score and a repeated probe (which repeats its list's
    candidates)."""
    plan = tscan.k6_plan(D, bits, group_size)
    n, rows = tscan.k6_splits(L, plan)
    assert n == splits
    s, pos = _slot_scores(L, D, bits, group_size, t, seed=L + D + t)
    want = tscan._best_first(s, pos, t)
    assert bool(((s == want[0][..., -1:]).sum(-1) > 1).all())  # ties at the t-th score
    parts = [tscan._best_first(s[..., r:r + rows], pos[..., r:r + rows], t) for r in range(0, L, rows)]
    got = tscan._best_first(torch.cat([p[0] for p in parts], -1), torch.cat([p[1] for p in parts], -1), t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(want[0][:, 0], want[0][:, -1]) and torch.equal(want[1][:, 0], want[1][:, -1])
    fin = torch.isfinite(want[0])
    assert bool(((want[0][..., :-1] >= want[0][..., 1:]) | ~fin[..., 1:]).all())  # best first


def _cpu_args(bits=8):
    gen = torch.Generator().manual_seed(1)
    C, L, D = 4, 128, 64
    q = torch.nn.functional.normalize(torch.randn(3, D, generator=gen), dim=1)
    cent = torch.nn.functional.normalize(torch.randn(C, D, generator=gen), dim=1)
    packed = torch.randint(-128, 128, (C, L, D // 2 if bits == 4 else D), generator=gen).to(torch.int8)
    scales = torch.full((C, L, D // 32), 0.01).to(torch.bfloat16)
    row_ids = torch.arange(C * L, dtype=torch.int32).reshape(C, L)
    probes = torch.tensor([[0, 1], [2, 2], [3, 0]], dtype=torch.int32)
    return q, cent, packed, scales, row_ids, probes


def test_candidates_cuda_raises_on_cpu_tensors():
    """K7's wrapper launches or raises: CPU tensors go to the plain version
    only through the dispatcher, which launches nothing."""
    from intel_extension_for_transformers_tpu_torch.utils import profile_ivf

    args = _cpu_args()
    kw = dict(t=8, bits=8, group_size=32, l_blk=128)
    before = tscan.ivf_scan_candidates_cuda.launches
    s, pos = tscan.ivf_scan_candidates(*args, **kw)
    assert s.shape == pos.shape == (3, 16) and tscan.ivf_scan_candidates_cuda.launches == before
    for fn in (tscan.ivf_scan_candidates_cuda, profile_ivf.yardstick_scan_candidates):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args, **kw)
    assert tscan.ivf_scan_candidates_cuda.launches == before


@pytest.mark.parametrize("bits,mult,offset", [(4, 3, 0), (4, 16, 5), (8, 4, 1)])
def test_candidates_cuda_raises_for_codes_it_cannot_decode(bits, mult, offset):
    """Codes `k6_check_codes` refuses raise before any launch (the plain
    version takes them)."""
    args = _cpu_args(bits)
    kw = dict(t=8, bits=bits, group_size=32, l_blk=128, code_mult=mult, code_offset=offset)
    with pytest.raises(ValueError, match="inexactly"):
        tscan.ivf_scan_candidates_cuda(*args, **kw)
    s, _ = tscan.ivf_scan_candidates_plain(*args, **kw)
    assert s.shape == (3, 16)
