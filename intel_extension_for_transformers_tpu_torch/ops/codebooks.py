"""4-bit codebooks (NF4, FP4) for weight-only quantization.

Same value tables the reference applies on the torch side before packing
(reference: llm/quantization/nn/modules.py:225-237 — nf4/fp4 transforms fed to
qbits packing). NF4 is the information-theoretically-optimal normal-float grid
from QLoRA; FP4 is e2m1 normalized to [-1, 1].
"""

import numpy as np

# QLoRA NF4 grid: quantiles of N(0,1), normalized to [-1, 1], 16 levels.
NF4_CODEBOOK = np.array(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=np.float32,
)

# FP4 e2m1: {0, 0.5, 1, 1.5, 2, 3, 4, 6} / 6 with signs, deduped to 16 slots
# (two zeros, matching the bitwise e2m1 layout: sign bit + 8 magnitudes).
_FP4_MAG = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], dtype=np.float32) / 6.0
FP4_CODEBOOK = np.concatenate([_FP4_MAG, -_FP4_MAG]).astype(np.float32)

CODEBOOKS = {
    "nf4": NF4_CODEBOOK,
    "fp4": FP4_CODEBOOK,
    "fp4_e2m1": FP4_CODEBOOK,
}


def get_codebook(name: str) -> np.ndarray:
    try:
        return CODEBOOKS[name]
    except KeyError:
        raise ValueError(f"unknown codebook {name!r}; have {sorted(CODEBOOKS)}")
