"""Synthetic embedding generators for retrieval-quality evaluation.

Real text-embedding corpora are clustered (topics), hierarchical (subtopics)
and anisotropic (per-dimension variance spread) — none of which a plain
gaussian cloud reproduces. Recall numbers measured on gaussians overstate an
index's quality on real data (the round-1 finding: near-collinear embeddings
break bf16 ranking, examples/text_embedding_mteb.py). These generators give
the harder, more honest distributions the quality tests and `bench.py` pin
recall on.

A numpy-only copy of `intel_extension_for_transformers_tpu/retrieval/
synthetic.py`, so both packages draw identical data from the same seed. The
JAX package's on-device generator (`clustered_embeddings_device`) is not
ported.
"""

from __future__ import annotations

import numpy as np


def clustered_embeddings(
    n: int,
    dim: int = 768,
    n_queries: int = 256,
    *,
    n_topics: int = 64,
    n_subtopics: int = 16,
    subtopic_scale: float = 0.5,
    noise_scale: float = 0.35,
    anisotropy: float = 0.7,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """→ (docs (n, dim), queries (n_queries, dim)), L2-normalized f32.

    Hierarchical mixture: unit topic centroids, subtopic offsets at
    `subtopic_scale`, log-normal per-dimension anisotropy at exp(N(0, a)).
    With the defaults, within-subtopic cosine ≈ 0.9 and the top-10 boundary
    sits among near-ties — the regime where low-bit encodings actually get
    stressed (median top1 ≈ 0.93, top10 ≈ 0.92 at n=100k).
    """
    rng = np.random.default_rng(seed)
    tops = rng.normal(size=(n_topics, dim)).astype(np.float32)
    tops /= np.linalg.norm(tops, axis=1, keepdims=True)
    subs = rng.normal(size=(n_topics, n_subtopics, dim)).astype(np.float32)
    subs /= np.linalg.norm(subs, axis=2, keepdims=True)
    aniso = np.exp(rng.normal(0, anisotropy, size=(dim,))).astype(np.float32)
    aniso /= np.sqrt((aniso**2).mean())

    def sample(m: int) -> np.ndarray:
        t = rng.integers(0, n_topics, size=m)
        s = rng.integers(0, n_subtopics, size=m)
        x = (
            tops[t]
            + subtopic_scale * subs[t, s]
            + noise_scale
            * rng.normal(size=(m, dim)).astype(np.float32)
            * aniso
            / np.sqrt(dim)
        )
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    return sample(n), sample(n_queries)


def gaussian_embeddings(
    n: int, dim: int = 768, n_queries: int = 256, *, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Normalized isotropic gaussian docs/queries (the easy distribution)."""
    rng = np.random.default_rng(seed)
    docs = rng.normal(size=(n, dim)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q = rng.normal(size=(n_queries, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return docs, q


def exact_topk(docs: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    """Full-precision exhaustive oracle (the FAISS IndexFlatIP stand-in)."""
    sims = queries.astype(np.float32) @ docs.astype(np.float32).T
    return np.argsort(-sims, axis=1)[:, :k]


def recall_at_k(ids: np.ndarray, oracle: np.ndarray) -> float:
    hits = 0
    for row, orow in zip(ids, oracle):
        hits += len(set(row.tolist()) & set(orow.tolist()))
    return hits / oracle.size
