"""On-device flat index with the int4 scan (K1) and the fused scan+top-2 (K5).

Port of `FlatIndex` from `intel_extension_for_transformers_tpu/retrieval/
index.py`, with f32, bf16 and int4 storage. int4 keeps the JAX package's
layout and accuracy levers: vectors are rotated by a random orthogonal
matrix, centered on the first batch's mean, and stored as group-wise
symmetric int4 in the khalf layout (D//2, capacity) with bf16 scales; an
optional bf16 shadow copy (`rescore_dtype="bfloat16"`) of the rotated
vectors enables two-tier search.

Search takes the structure of the JAX package's accelerator branch on every
device:

- int4: the scan is `woq_matmul` over the packed docs (K1 on the card),
  with the q·mean correction added back; with a shadow, the top-m
  candidates are rescored exactly against it.
- `approx_rescore` at B >= 64 and size >= 4096 on a float index, or on an
  int4 index with a shadow: the fused scan+top-2 (K5) over the float docs
  (the shadow, in rotated space), then the top-k of the per-tile winners.

`torch.topk` is exact, so "approx" and "approx_rescore" (which used
`lax.approx_max_k`, approximate on a TPU) return the exact top-k wherever the
score matrix is materialized. int8 storage, k-means anchors and
`ShardedFlatIndex` are not ported yet.

The JAX package draws its rotation with `jax.random.orthogonal`; this one
draws a Haar rotation from a `torch.Generator`, a different matrix for the
same seed. `save` therefore stores the rotation, and `load` refuses a
rotated int4 index saved without one unless it is passed in.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from intel_extension_for_transformers_tpu_torch.ops.packing import (
    QuantizedTensor,
    quantize_groupwise,
)
from intel_extension_for_transformers_tpu_torch.ops.quant_matmul import woq_matmul
from intel_extension_for_transformers_tpu_torch.ops.scan_topk import scan_topk_candidates

__all__ = ["FlatIndex", "random_rotation"]

FUSED_MIN_BATCH = 64
FUSED_MIN_SIZE = 4096


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    xf = x.to(torch.float32)
    n = torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
    return (xf / n.clamp_min(eps)).to(x.dtype)


def random_rotation(dim: int, seed: int = 0) -> torch.Tensor:
    """Haar-random orthogonal (dim, dim) f32 on the CPU, deterministic in `seed`."""
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(dim, dim, generator=gen, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    return (q * torch.sign(torch.diagonal(r))[None, :]).to(torch.float32)


def _int4_qt(data, scales, dim, group_size) -> QuantizedTensor:
    """View packed column-major doc storage as a (K=dim, N=cols) weight."""
    return QuantizedTensor(
        data=data, scales=scales, zeros=None, weight_dtype="int4", scheme="sym",
        group_size=group_size, K=dim, N=data.shape[1],
    )


def _int4_scores(qrot, data, scales, mean, group_size: int, out_dtype):
    """→ (B, N) inner-product scores, the mean correction added back.

    bf16 output (when a shadow will rescore) halves the bytes of the (B, N)
    matrix."""
    qt = _int4_qt(data, scales, qrot.shape[-1], group_size)
    sims = woq_matmul(qrot.to(torch.bfloat16), qt, out_dtype=out_dtype)
    if mean is not None:
        sims = sims + (qrot @ mean)[:, None].to(out_dtype)
    return sims


def _int4_search(qrot, data, scales, mean, valid, shadow, *, k, group_size, oversample):
    scan_dtype = torch.float32 if shadow is None else torch.bfloat16
    sims = _int4_scores(qrot, data, scales, mean, group_size, scan_dtype)
    sims = sims.masked_fill(~valid[None, :], -torch.inf)
    if shadow is None:
        return torch.topk(sims, k, dim=1)
    # two-tier: the int4 scan selects m candidates; exact rescore ranks them
    m = min(max(oversample, k), sims.shape[-1])
    cand = torch.topk(sims, m, dim=1).indices
    cvecs = shadow[cand].to(torch.float32)  # (B, m, D) full rotated vectors
    rescored = torch.einsum("bd,bmd->bm", qrot.to(torch.float32), cvecs)
    best, pos = torch.topk(rescored, k, dim=1)
    return best, torch.gather(cand, 1, pos)


def _dense_scores(queries, vectors):
    """f32 storage scores in full f32; bf16 storage from bf16 products."""
    q = queries.to(vectors.dtype).to(torch.float32)
    return q @ vectors.to(torch.float32).T


class FlatIndex:
    """Flat inner-product / cosine index on one device.

    Storage is preallocated and doubles when full. int4 mode
    (`dtype="int4"`) holds ~0.27x the bytes of bf16 storage; with
    `rescore_dtype="bfloat16"` a bf16 shadow is kept for two-tier search.
    """

    def __init__(
        self,
        dim: int,
        dtype: str = "bfloat16",  # "float32" | "bfloat16" | "int4"
        metric: str = "ip",  # "ip" | "cosine"
        capacity: int = 4096,
        *,
        group_size: int = 64,  # int4: scale granularity along dim
        rotate: bool = True,  # int4: random orthogonal pre-rotation
        center: bool = True,  # int4: subtract the first batch's mean pre-encode
        rescore_dtype: Optional[str] = None,  # int4: "bfloat16" | "float32"
        rotation_seed: int = 0,
        device="cpu",
    ):
        if dtype == "int8":
            raise NotImplementedError("int8 index storage is not ported yet")
        if dtype not in ("float32", "bfloat16", "int4"):
            raise ValueError(f"unsupported index dtype {dtype}")
        if metric not in ("ip", "cosine"):
            raise ValueError(f"unsupported metric {metric}")
        if rescore_dtype is not None and dtype != "int4":
            raise ValueError("rescore_dtype is only meaningful for dtype='int4'")
        self.dim = dim
        self.dtype = dtype
        self.metric = metric
        self.size = 0
        self._capacity = max(int(capacity), 8)
        self.group_size = group_size
        self.rotate = rotate
        self.center = center
        self.rescore_dtype = rescore_dtype
        self.rotation_seed = rotation_seed
        self.device = torch.device(device)

        cap, dev = self._capacity, self.device
        if dtype == "int4":
            if dim % 2:
                raise ValueError("int4 index needs even dim")
            if (dim // 2) % group_size:
                raise ValueError(f"group_size={group_size} must divide dim//2={dim // 2}")
            self._rotation = random_rotation(dim, rotation_seed).to(dev) if rotate else None
            self._mean: Optional[torch.Tensor] = None  # (D,) rotated space
            self._data = torch.zeros((dim // 2, cap), dtype=torch.int8, device=dev)
            self._scales = torch.zeros((dim // group_size, cap), dtype=torch.bfloat16, device=dev)
            self._shadow = (
                torch.zeros((cap, dim), dtype=getattr(torch, rescore_dtype), device=dev)
                if rescore_dtype
                else None
            )
            self._vectors = None
        else:
            self._vectors = torch.zeros((cap, dim), dtype=getattr(torch, dtype), device=dev)

    def __len__(self) -> int:
        return self.size

    @property
    def nbytes(self) -> int:
        """Payload bytes of the filled rows."""
        n = self.size
        if self.dtype == "int4":
            b = (self.dim // 2) * n + 2 * (self.dim // self.group_size) * n
            if self._shadow is not None:
                b += self._shadow.element_size() * self.dim * n
            return b
        return self._vectors.element_size() * self.dim * n

    def _to_device(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        return x.to(self.device)

    # ------------------------------ add ------------------------------

    def _grow(self, need: int) -> None:
        new_cap = self._capacity
        while new_cap < need:
            new_cap *= 2
        pad = new_cap - self._capacity
        if pad == 0:
            return

        def cols(t):
            return torch.cat([t, t.new_zeros((t.shape[0], pad))], dim=1)

        def rows(t):
            return torch.cat([t, t.new_zeros((pad, t.shape[1]))], dim=0)

        if self.dtype == "int4":
            self._data = cols(self._data)
            self._scales = cols(self._scales)
            if self._shadow is not None:
                self._shadow = rows(self._shadow)
        else:
            self._vectors = rows(self._vectors)
        self._capacity = new_cap

    def _encode_int4(self, vectors: torch.Tensor):
        """→ (data (D//2, M), scales (G, M) bf16, shadow (M, D) | None)."""
        x = vectors.to(torch.float32)
        if self._rotation is not None:
            x = x @ self._rotation
        shadow = x.to(getattr(torch, self.rescore_dtype)) if self.rescore_dtype else None
        if self.center and self._mean is None:
            self._mean = x.mean(dim=0)
        if self._mean is not None:
            x = x - self._mean
        qt = quantize_groupwise(x.T, "int4", "sym", self.group_size, scale_dtype=torch.bfloat16)
        return qt.data, qt.scales, shadow

    @torch.inference_mode()
    def add(self, vectors) -> np.ndarray:
        """Insert (M, D) vectors; returns their assigned ids."""
        vectors = self._to_device(vectors)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(f"expected (M, {self.dim}) vectors, got {tuple(vectors.shape)}")
        M = vectors.shape[0]
        if self.metric == "cosine":
            vectors = _l2_normalize(vectors)
        self._grow(self.size + M)
        s0, s1 = self.size, self.size + M
        if self.dtype == "int4":
            data, scales, shadow = self._encode_int4(vectors)
            self._data[:, s0:s1] = data
            self._scales[:, s0:s1] = scales
            if shadow is not None:
                self._shadow[s0:s1] = shadow
        else:
            self._vectors[s0:s1] = vectors.to(self._vectors.dtype)
        self.size = s1
        return np.arange(s0, s1)

    # ----------------------------- search -----------------------------

    @torch.inference_mode()
    def search(
        self,
        queries,
        k: int = 10,
        method: str = "exact",
        oversample: int = 64,
    ) -> tuple[np.ndarray, np.ndarray]:
        """→ (scores (B, k) f32, ids (B, k) int32) as numpy.

        method: "exact" | "approx" | "approx_rescore" (see the module docstring).
        """
        if self.size == 0:
            raise ValueError("index is empty")
        if method not in ("exact", "approx", "approx_rescore"):
            raise ValueError(f"unknown search method {method!r}")
        queries = self._to_device(queries)
        squeeze = queries.ndim == 1
        if squeeze:
            queries = queries[None, :]
        if self.metric == "cosine":
            queries = _l2_normalize(queries)
        k = min(k, self.size)
        fused = self._fused_scan_search(queries, k, method, oversample)
        if fused is not None:
            scores, ids = fused
        else:
            valid = torch.arange(self._capacity, device=self.device) < self.size
            if self.dtype == "int4":
                qrot = queries.to(torch.float32)
                if self._rotation is not None:
                    qrot = qrot @ self._rotation
                scores, ids = _int4_search(
                    qrot, self._data, self._scales, self._mean, valid, self._shadow,
                    k=k, group_size=self.group_size, oversample=oversample,
                )
            else:
                sims = _dense_scores(queries, self._vectors)
                scores, ids = torch.topk(sims.masked_fill(~valid[None, :], -torch.inf), k, dim=1)
        scores = scores.to(torch.float32).cpu().numpy()
        ids = ids.to(torch.int32).cpu().numpy()
        if squeeze:
            return scores[0], ids[0]
        return scores, ids

    def _fused_scan_search(self, queries, k, method, oversample):
        """The fused scan+top-2 (K5) for approx_rescore on float indexes and
        on int4 indexes with a shadow; None where it does not apply (other
        methods, batches under 64 queries, indexes under 4096 rows)."""
        if method != "approx_rescore":
            return None
        if queries.shape[0] < FUSED_MIN_BATCH or self.size < FUSED_MIN_SIZE:
            return None
        if self.dtype in ("float32", "bfloat16"):
            docs, q = self._vectors, queries
        elif self._shadow is not None:
            docs = self._shadow
            q = queries.to(torch.float32)
            if self._rotation is not None:
                q = q @ self._rotation  # the shadow lives in rotated space
        else:
            return None
        scores, ids = scan_topk_candidates(q, docs, self.size, m=max(oversample, k))
        return scores[:, :k], ids[:, :k]

    # ----------------------------- persistence -----------------------------

    def state(self) -> tuple[dict, dict]:
        """→ (meta, arrays): the JSON metadata and the numpy arrays of the
        filled rows, in the JAX package's save format plus `rotation`."""
        n = self.size
        meta = {
            "type": "flat", "dim": self.dim, "dtype": self.dtype, "metric": self.metric,
            "size": n, "group_size": self.group_size, "rotate": self.rotate,
            "center": self.center, "rescore_dtype": self.rescore_dtype,
            "rotation_seed": self.rotation_seed,
        }

        def f32(t):
            return t.to(torch.float32).cpu().numpy()

        if self.dtype == "int4":
            arrays = {"data": self._data[:, :n].cpu().numpy(), "scales": f32(self._scales[:, :n])}
            if self._mean is not None:
                arrays["mean"] = f32(self._mean)
            if self._shadow is not None:
                arrays["shadow"] = f32(self._shadow[:n])
            if self._rotation is not None:
                arrays["rotation"] = f32(self._rotation)
        else:
            arrays = {"vectors": f32(self._vectors[:n])}
        return meta, arrays

    @classmethod
    def from_state(cls, meta: dict, arrays: dict, device="cpu") -> "FlatIndex":
        """Build an index from `state()`'s output (or the JAX package's save
        format). A rotated int4 index needs `arrays["rotation"]`."""
        n = meta["size"]
        if "anchors" in arrays:
            raise NotImplementedError("k-means anchors are not ported yet")
        idx = cls(
            meta["dim"], meta["dtype"], meta["metric"],
            capacity=meta.get("capacity", max(n, 8)),
            group_size=meta.get("group_size", 64),
            rotate=meta.get("rotate", True),
            center=meta.get("center", True),
            rescore_dtype=meta.get("rescore_dtype"),
            rotation_seed=meta.get("rotation_seed", 0),
            device=device,
        )

        def put(x, dtype):
            return torch.as_tensor(np.array(x)).to(device=idx.device, dtype=dtype)

        if idx.dtype == "int4":
            if idx.rotate:
                if arrays.get("rotation") is None:
                    raise ValueError(
                        "rotated int4 index has no rotation matrix; pass the one it "
                        "was built with"
                    )
                idx._rotation = put(arrays["rotation"], torch.float32)
            idx._data[:, :n] = put(arrays["data"][:, :n], torch.int8)
            idx._scales[:, :n] = put(arrays["scales"][:, :n], torch.bfloat16)
            if arrays.get("mean") is not None:
                idx._mean = put(arrays["mean"], torch.float32)
            if idx._shadow is not None and arrays.get("shadow") is not None:
                idx._shadow[:n] = put(arrays["shadow"][:n], idx._shadow.dtype)
        else:
            idx._vectors[:n] = put(arrays["vectors"][:n], idx._vectors.dtype)
        idx.size = n
        return idx

    def save(self, path: str) -> None:
        """Write index.npz + index.json (the JAX package loads it too; it
        ignores the extra `rotation` array)."""
        os.makedirs(path, exist_ok=True)
        meta, arrays = self.state()
        np.savez(os.path.join(path, "index.npz"), **arrays)
        with open(os.path.join(path, "index.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, *, rotation=None, device="cpu") -> "FlatIndex":
        """Load a saved index. `rotation` supplies the matrix for a rotated
        int4 index saved without one (e.g. by the JAX package)."""
        with open(os.path.join(path, "index.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "index.npz")) as npz:
            arrays = {key: npz[key] for key in npz.files}
        if rotation is not None:
            arrays["rotation"] = rotation
        return cls.from_state(meta, arrays, device)
