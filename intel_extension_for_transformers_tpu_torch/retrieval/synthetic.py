"""Synthetic embedding generators for retrieval-quality evaluation.

Real text-embedding corpora are clustered (topics), hierarchical (subtopics)
and anisotropic (per-dimension variance spread) — none of which a plain
gaussian cloud reproduces. Recall numbers measured on gaussians overstate an
index's quality on real data (the round-1 finding: near-collinear embeddings
break bf16 ranking, examples/text_embedding_mteb.py). These generators give
the harder, more honest distributions the quality tests and `bench.py` pin
recall on.

The numpy generators are copies of `intel_extension_for_transformers_tpu/
retrieval/synthetic.py`, so both packages draw identical data from the same
seed. `clustered_embeddings_device` draws the same distribution on the card
from a `torch.Generator` (not the same draws as either package's).
"""

from __future__ import annotations

import numpy as np
import torch

from intel_extension_for_transformers_tpu_torch.utils.device import resolve_device


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


def clustered_embeddings_device(
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
    chunk: int = 500_000,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`clustered_embeddings` drawn on the device → (docs (n, dim), queries
    (n_queries, dim)) f32 tensors there, L2-normalized.

    The same hierarchical mixture, drawn from a `torch.Generator` on the
    device: the same distribution as the numpy generator and the JAX
    package's `jax.random` one, not the same draws. Docs are drawn `chunk`
    rows at a time into one preallocated tensor, so the temporaries stay
    small; the queries are drawn before the docs, so they do not depend on
    `n`. Exists for the 10M-row runs, where host numpy takes minutes per
    million rows."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    tops = torch.nn.functional.normalize(normal(n_topics, dim), dim=1)
    subs = torch.nn.functional.normalize(normal(n_topics, n_subtopics, dim), dim=2)
    aniso = torch.exp(anisotropy * normal(dim))
    aniso = aniso / torch.sqrt((aniso**2).mean())
    noise = noise_scale * aniso / float(np.sqrt(dim))

    def sample(out: torch.Tensor) -> torch.Tensor:
        m = out.shape[0]
        t = torch.randint(0, n_topics, (m,), generator=gen, device=dev)
        s = torch.randint(0, n_subtopics, (m,), generator=gen, device=dev)
        x = tops[t] + subtopic_scale * subs[t, s] + normal(m, dim) * noise
        return out.copy_(x / torch.linalg.vector_norm(x, dim=1, keepdim=True))

    queries = sample(torch.empty((n_queries, dim), device=dev))
    docs = torch.empty((n, dim), device=dev)
    for i in range(0, n, chunk):
        sample(docs[i : i + chunk])
    return docs, queries


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
