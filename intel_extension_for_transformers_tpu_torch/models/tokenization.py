"""Minimal self-contained tokenizer.

Port of `ByteTokenizer` from `intel_extension_for_transformers_tpu/models/
tokenization.py`: a reversible byte-level tokenizer (256 byte ids plus BOS,
EOS and PAD) for tests, demos and offline runs where no tokenizer files
exist. `HybridBPETokenizer` (HF fast tokenizer with a native BPE path) is
not ported yet.
"""

from __future__ import annotations

from typing import List

import numpy as np


class ByteTokenizer:
    """ids 0..255 = bytes; 256 = BOS, 257 = EOS, 258 = PAD."""

    vocab_size = 259
    bos_token_id = 256
    eos_token_id = 257
    pad_token_id = 258

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8", errors="replace"))
        return ([self.bos_token_id] if add_bos else []) + ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        bs = bytes(i for i in ids if 0 <= int(i) < 256)
        return bs.decode("utf-8", errors="ignore")

    def __call__(self, texts, padding=True, truncation=True, max_length=512, **kw):
        if isinstance(texts, str):
            texts = [texts]
        seqs = [self.encode(t)[:max_length] for t in texts]
        L = max(len(s) for s in seqs)
        input_ids = np.full((len(seqs), L), self.pad_token_id, np.int32)
        mask = np.zeros((len(seqs), L), np.int32)
        for i, s in enumerate(seqs):
            input_ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return {"input_ids": input_ids, "attention_mask": mask}
