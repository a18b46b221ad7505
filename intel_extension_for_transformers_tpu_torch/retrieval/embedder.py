"""Batched text embedding: tokenizer → BGE encoder → vectors.

Port of `intel_extension_for_transformers_tpu/retrieval/embedder.py`.
Sequence lengths round up to a fixed bucket ladder and every batch is padded
to (batch_size, bucket), so the encoder sees a handful of shapes, as in the
JAX package. With the default batch of 128 rows every encoder call has
M = 128·bucket >= 4096 rows, so an INT4 encoder's linear layers take the
dequantize-once branch of `woq_matmul`. The encoder runs on the device its
parameters are on; `encode` returns numpy.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, List, Sequence

import numpy as np
import torch

from intel_extension_for_transformers_tpu_torch.models.bert import (
    BertConfig,
    BertModel,
    bert_encode,
)

DEFAULT_BUCKETS = (32, 64, 128, 256, 512)


class SimpleTokenizer:
    """Hash-based whitespace tokenizer for tests/offline use — stands in for
    a HF tokenizer when no vocab is available. Same ids as the JAX package's."""

    def __init__(self, vocab_size: int = 30522, cls_id: int = 101, sep_id: int = 102):
        self.vocab_size = vocab_size
        self.cls_id = cls_id
        self.sep_id = sep_id

    def encode_one(self, text: str, max_length: int) -> List[int]:
        ids = [self.cls_id]
        for tok in text.lower().split():
            h = int(hashlib.md5(tok.encode()).hexdigest()[:8], 16)
            ids.append(200 + h % (self.vocab_size - 300))
            if len(ids) >= max_length - 1:
                break
        ids.append(self.sep_id)
        return ids

    def __call__(self, texts, padding=True, truncation=True, max_length=512, **kw):
        if isinstance(texts, str):
            texts = [texts]
        seqs = [self.encode_one(t, max_length) for t in texts]
        L = max(len(s) for s in seqs)
        input_ids = np.zeros((len(seqs), L), np.int32)
        mask = np.zeros((len(seqs), L), np.int32)
        for i, s in enumerate(seqs):
            input_ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return {"input_ids": input_ids, "attention_mask": mask}


def _bucket_for(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


class TextEmbedder:
    """encode(texts) → (N, H) normalized embeddings; queries
    (`is_query=True`) get the BGE instruction prefix."""

    def __init__(
        self,
        model: BertModel,
        config: BertConfig,
        tokenizer=None,
        *,
        batch_size: int = 128,
        max_length: int = 512,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        pooling: str = "cls",
        normalize: bool = True,
        query_instruction: str = "",
    ):
        self.model = model
        self.config = config
        self.tokenizer = tokenizer or SimpleTokenizer(config.vocab_size)
        self.batch_size = batch_size
        self.max_length = max_length
        self.buckets = tuple(b for b in buckets if b <= max_length) or (max_length,)
        self.pooling = pooling
        self.normalize = normalize
        self.query_instruction = query_instruction

    @property
    def device(self) -> torch.device:
        return self.model.embeddings.word_embeddings.device

    @torch.inference_mode()
    def _encode_batch(self, input_ids, attention_mask) -> np.ndarray:
        dev = self.device
        emb = bert_encode(
            self.model,
            torch.as_tensor(input_ids, device=dev),
            torch.as_tensor(attention_mask, device=dev),
            pooling=self.pooling,
            normalize=self.normalize,
        )
        return emb.to(torch.float32).cpu().numpy()

    def encode(self, texts: Iterable[str], is_query: bool = False) -> np.ndarray:
        texts = list(texts)
        if not texts:
            return np.zeros((0, self.config.hidden_size), np.float32)
        if is_query and self.query_instruction:
            texts = [self.query_instruction + t for t in texts]

        enc = self.tokenizer(
            texts, padding=True, truncation=True, max_length=self.max_length
        )
        input_ids = np.asarray(enc["input_ids"], np.int32)
        mask = np.asarray(enc["attention_mask"], np.int32)
        lengths = mask.sum(axis=1)

        out = np.zeros((len(texts), self.config.hidden_size), np.float32)
        # group rows by bucket to bound the number of distinct shapes
        order = np.argsort(lengths, kind="stable")
        i = 0
        while i < len(order):
            bucket = _bucket_for(int(lengths[order[i]]), self.buckets)
            batch_rows = [order[i]]
            i += 1
            while (
                i < len(order)
                and len(batch_rows) < self.batch_size
                and _bucket_for(int(lengths[order[i]]), self.buckets) == bucket
            ):
                batch_rows.append(order[i])
                i += 1
            rows = np.asarray(batch_rows)
            B = len(rows)
            # pad rows to (batch_size, bucket) so shapes stay in the ladder
            bi = np.zeros((self.batch_size, bucket), np.int32)
            bm = np.zeros((self.batch_size, bucket), np.int32)
            L = min(input_ids.shape[1], bucket)
            bi[:B, :L] = input_ids[rows][:, :L]
            bm[:B, :L] = mask[rows][:, :L]
            out[rows] = self._encode_batch(bi, bm)[:B]
        return out
