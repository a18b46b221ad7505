"""Port parity: flash attention against the JAX package's Pallas kernel
(_flash_kernel, interpret mode here), and the plain attention (GQA, masks,
bias) against the JAX one. On a CPU tensor `flash_attention` runs K4's plain
version, which keeps the kernel's masks and its -1e30 convention."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intel_extension_for_transformers_tpu.ops import flash_attention as jfa
from intel_extension_for_transformers_tpu.ops import layers as jl
from intel_extension_for_transformers_tpu_torch.ops import flash_attention as tfa
from intel_extension_for_transformers_tpu_torch.ops import layers as tl

torch.set_num_threads(1)

# Max absolute error, f32 everywhere. Inputs are N(0, 0.25); both sides take
# f32 logits, exp and sums, the Pallas kernel block by block with the
# online-softmax rescaling and the plain version in one pass, so the outputs
# differ by f32 rounding of O(1) values: 1e-5 bounds it.
ATOL = 1e-5
# bf16 inputs and output: both round the f32 result to bf16 once, and a tie
# broken the other way is one bf16 ulp of an O(1) value.
BF16_ATOL = 2**-7


def _qkv(B, T, S, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape) * 0.5).astype(np.float32)
            for shape in ((B, T, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]


def _both(arrays, dtype="float32", **kw):
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in arrays)
    want = jfa.flash_attention(jq, jk, jv, interpret=True, **kw)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    got = tfa.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("T", [128, 300])
def test_causal_matches_pallas(T):
    got, want = _both(_qkv(2, T, T, 4, 4, 64, T), causal=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_gqa_matches_pallas():
    got, want = _both(_qkv(1, 128, 128, 8, 2, 64, 1), causal=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_non_causal_ragged_s_matches_pallas():
    """S != T and S not a multiple of the Pallas key block (keys past S masked)."""
    got, want = _both(_qkv(1, 64, 200, 2, 2, 40, 2), causal=False)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_q_offset_matches_pallas():
    got, want = _both(_qkv(1, 96, 256, 4, 2, 64, 3), causal=True, q_offset=160)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_explicit_scale_matches_pallas():
    got, want = _both(_qkv(1, 64, 64, 2, 2, 32, 4), causal=True, scale=0.3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_bfloat16_matches_pallas():
    got, want = _both(_qkv(1, 128, 128, 2, 2, 64, 5), "bfloat16", causal=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)


def test_rejects_negative_offset_and_bad_shapes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 4, 3, 16, 6))
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v)  # 4 heads over 3 KV heads
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 4, 2, 16, 6))
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v, q_offset=-1)


@pytest.mark.parametrize("Hkv", [4, 2])
def test_plain_attention_gqa_mask_bias_matches_jax(Hkv):
    """Tolerance: 1e-5 absolute, f32 logits and softmax on both sides."""
    q, k, v = _qkv(2, 16, 24, 4, Hkv, 32, 7)
    rng = np.random.default_rng(8)
    mask = rng.random((2, 1, 16, 24)) > 0.3
    mask[..., 0] = True
    bias = rng.normal(size=(1, 4, 16, 24)).astype(np.float32)
    want = jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        mask=jnp.asarray(mask), bias=jnp.asarray(bias))
    got = tl.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                       mask=torch.from_numpy(mask), bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_causal_mask_matches_jax():
    """Tolerance: none (a boolean mask)."""
    for Tq, Tk, off in ((5, 5, 0), (3, 9, 6)):
        np.testing.assert_array_equal(
            tl.make_causal_mask(Tq, Tk, off).numpy(), np.asarray(jl.make_causal_mask(Tq, Tk, off))
        )
