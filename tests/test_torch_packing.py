"""Port parity: group-wise quantization and packing, bit for bit against the
JAX package (intel_extension_for_transformers_tpu/ops/packing.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intel_extension_for_transformers_tpu.ops import packing as jpk
from intel_extension_for_transformers_tpu_torch.ops import packing as tpk

torch.set_num_threads(1)

SCHEMES = [
    ("int4", "sym"),
    ("int4", "asym"),
    ("int3", "sym"),
    ("nf4", "sym"),
    ("fp4", "sym"),
    ("int8", "sym"),
    ("int8", "asym"),
]


def _f32(x):
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_dtype,scheme", SCHEMES)
def test_quantize_groupwise_bit_identical(weight_dtype, scheme, scale_dtype):
    """Tolerance: none. Packed bytes, scales, zero points and the dequantized
    weight are equal to the JAX package's."""
    w = np.random.default_rng(0).normal(size=(256, 300)).astype(np.float32)
    jq = jpk.quantize_groupwise(
        jnp.asarray(w), weight_dtype, scheme, 64, scale_dtype=getattr(jnp, scale_dtype)
    )
    tq = tpk.quantize_groupwise(
        torch.from_numpy(w), weight_dtype, scheme, 64, scale_dtype=getattr(torch, scale_dtype)
    )
    assert (tq.weight_dtype, tq.scheme, tq.K, tq.N) == (jq.weight_dtype, jq.scheme, jq.K, jq.N)
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    np.testing.assert_array_equal(tq.scales.float().numpy(), _f32(jq.scales))
    assert (tq.zeros is None) == (jq.zeros is None)
    if jq.zeros is not None:
        np.testing.assert_array_equal(tq.zeros.float().numpy(), _f32(jq.zeros))
    np.testing.assert_array_equal(tpk.dequantize(tq).numpy(), np.asarray(jpk.dequantize(jq)))


@pytest.mark.parametrize("signed", [True, False])
def test_pack_unpack_int4_matches_jax(signed):
    """Tolerance: none. khalf packing of every nibble value round-trips."""
    lo, hi = (-8, 8) if signed else (0, 16)
    q = np.random.default_rng(1).integers(lo, hi, size=(64, 40)).astype(np.int8)
    packed = tpk.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpk.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(tpk.unpack_int4(packed, signed).numpy(), q)


def test_quantize_transposed_weight_gives_contiguous_buffers():
    """A transposed view (nn.Linear's weight.T) packs to the same bytes, in
    row-major buffers, so the kernels' wrappers copy nothing per call."""
    w = torch.randn(64, 256)
    for scheme in ("sym", "asym"):
        view = tpk.quantize_groupwise(w.T, "int4", scheme, 32)
        dense = tpk.quantize_groupwise(w.T.contiguous(), "int4", scheme, 32)
        for name in ("data", "scales", "zeros"):
            got, want = getattr(view, name), getattr(dense, name)
            if want is None:
                assert got is None
                continue
            assert got.is_contiguous()
            assert torch.equal(got, want)
