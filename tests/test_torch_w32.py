"""Port parity: the w32 decode layout and K3's plain version against the JAX
package, whose w32 Pallas kernel (_woq_kernel_w32) runs here in interpret
mode. The repack is an integer codec, so it must match bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from intel_extension_for_transformers_tpu.ops import packing as jpk
from intel_extension_for_transformers_tpu.ops import quant_matmul as jqm
from intel_extension_for_transformers_tpu_torch.ops import packing as tpk
from intel_extension_for_transformers_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(1)

# K = 1280 pads to 1536 (g = 32, 64: unit 512) or 2048 (g = 128: unit 1024);
# N = 300 is ragged for the Pallas kernel's 256-column tile
K, N = 1280, 300
# Relative Frobenius error against the Pallas kernel. Both sides round x (in
# bf16 compute) and, on the fold branch, the folded weight at the same places
# and sum in f32, so only the summation order differs: 1e-5 bounds it. The m1
# branch sums x * (128 + v') and subtracts 136 * s * sum(x_g) afterwards; the
# two terms are ~40x the result (136 against |v - 8| of ~3), so the f32
# rounding of both, summed over K / g groups in another order, reaches a few
# 1e-5: 5e-5 bounds it.
REL_TOL = 1e-5
M1_REL_TOL = 5e-5


def _weights(scheme, g, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    jq = jpk.quantize_groupwise(jnp.asarray(w), "int4", scheme, g)
    tq = tpk.quantize_groupwise(torch.from_numpy(w), "int4", scheme, g)
    return jq, tq


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("scheme", ["sym", "asym"])
def test_repack_bit_identical(scheme, g):
    """Tolerance: none. Words, padded scales and zeros equal the JAX ones."""
    jq, tq = _weights(scheme, g, seed=g)
    j32, t32 = jpk.to_decode_layout(jq), tpk.to_decode_layout(tq)
    Kp = jpk.decode_layout_pad(K, g)
    assert tpk.decode_layout_pad(K, g) == Kp > K
    assert t32.layout == "w32" and t32.data.dtype == torch.int32
    assert t32.data.shape == (Kp // 8, N)
    np.testing.assert_array_equal(t32.data.numpy(), np.asarray(j32.data))
    np.testing.assert_array_equal(t32.scales.numpy(), np.asarray(j32.scales))
    if scheme == "asym":
        np.testing.assert_array_equal(t32.zeros.numpy(), np.asarray(j32.zeros))
    back = tpk.from_decode_layout(t32)
    assert back.layout == "khalf"
    np.testing.assert_array_equal(back.data.numpy(), tq.data.numpy())
    np.testing.assert_array_equal(back.scales.numpy(), tq.scales.numpy())
    np.testing.assert_array_equal(tpk.dequantize(t32).numpy(), tpk.dequantize(tq).numpy())


def test_w32_slot_order():
    """Tolerance: none. Slot s < 4 of word kw holds row 128 s + 2 kw, slot
    s >= 4 row 128 (s - 4) + 2 kw + 1; a sym nibble is biased by ^ 8."""
    q = torch.arange(512, dtype=torch.int32)[:, None] % 16 - 8  # row r -> (r % 16) - 8
    qt = tpk.QuantizedTensor(
        data=tpk.pack_int4(q), scales=torch.ones(4, 1), zeros=None, group_size=128, K=512, N=1
    )
    words = tpk.to_decode_layout(qt).data[:, 0].to(torch.int64) & 0xFFFFFFFF
    for kw in (0, 5, 63):
        for s in range(8):
            row = 128 * (s % 4) + 2 * kw + (s >= 4)
            assert (int(words[kw]) >> (4 * s)) & 0xF == ((row % 16 - 8) ^ 8) & 0xF


def test_int8_and_codebook_stay_khalf():
    w = torch.randn(256, 64)
    for dt in ("int8", "nf4"):
        qt = tpk.quantize_groupwise(w, dt, "sym", 64)
        assert tpk.to_decode_layout(qt) is qt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 5, 200])  # m1 branch (M <= 32) and fold branch (g < 128)
@pytest.mark.parametrize("scheme", ["sym", "asym"])
def test_w32_plain_matches_pallas_kernel(scheme, M, dtype):
    jq, tq = _weights(scheme, 32, seed=12)
    j32, t32 = jpk.to_decode_layout(jq), tpk.to_decode_layout(tq)
    x = np.random.default_rng(M).normal(size=(M, K)).astype(np.float32)
    assert tqm.w32_m1_path(M, 32) == (M <= 32)
    want = jqm.woq_matmul(jnp.asarray(x).astype(dtype), j32, out_dtype=jnp.float32, interpret=True)
    got = tqm.woq_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), t32, torch.float32)
    assert got.shape == (M, N) and got.dtype == torch.float32
    assert _rel(got.numpy(), np.asarray(want)) <= (M1_REL_TOL if M <= 32 else REL_TOL)


@pytest.mark.parametrize("M", [1, 40])
def test_w32_plain_g128_matches_pallas_kernel(M):
    """g = 128 takes the m1 branch at every M (the Llama path's shape)."""
    jq, tq = _weights("sym", 128, seed=7)
    j32, t32 = jpk.to_decode_layout(jq), tpk.to_decode_layout(tq)
    assert tqm.w32_m1_path(M, 128)
    x = np.random.default_rng(M + 1).normal(size=(M, K)).astype(np.float32)
    want = jqm.woq_matmul(jnp.asarray(x).astype("bfloat16"), j32, out_dtype=jnp.float32, interpret=True)
    got = tqm.woq_matmul(torch.from_numpy(x).to(torch.bfloat16), t32, torch.float32)
    assert _rel(got.numpy(), np.asarray(want)) <= M1_REL_TOL


def test_w32_dispatch_precedes_dequantize_once(monkeypatch):
    """A w32 weight goes to K3's path at M >= 1024 too, as in the JAX
    package (quant_matmul.py:570 before :584); a khalf one does not."""
    _, tq = _weights("sym", 128, seed=3)
    t32 = tpk.to_decode_layout(tq)
    calls = []
    real = tqm.woq_w32_plain
    monkeypatch.setattr(tqm, "woq_w32_plain", lambda *a: calls.append(1) or real(*a))
    x = torch.randn(1024, K)
    out32 = tqm.woq_matmul(x, t32)
    assert calls == [1]
    outk = tqm.woq_matmul(x, tq)
    assert calls == [1]
    assert _rel(out32.numpy(), outk.numpy()) <= M1_REL_TOL


def test_prepare_for_inference_swaps_woq_linears():
    """Every int4 WOQLinear becomes w32; an int8 one and float layers stay."""
    model = nn.Sequential(
        tqm.WOQLinear(tpk.quantize_groupwise(torch.randn(256, 64), "int4", "sym", 64)),
        tqm.WOQLinear(tpk.quantize_groupwise(torch.randn(64, 32), "int8", "sym", 32)),
        nn.Linear(32, 8),
    )
    x = torch.randn(3, 256)
    with torch.no_grad():
        before = model(x)
        assert tpk.prepare_for_inference(model) is model
        after = model(x)
    assert model[0].qt.layout == "w32" and model[0].data.dtype == torch.int32
    assert model[1].qt.layout == "khalf"
    assert "layout=w32" in model[0].extra_repr()
    assert _rel(after.numpy(), before.numpy()) <= M1_REL_TOL
