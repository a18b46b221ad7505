"""BERT-family encoder (BGE embedding models) as `nn.Module`s.

Port of `intel_extension_for_transformers_tpu/models/bert.py`. The module
tree mirrors the JAX params tree (embeddings / layers[i] / attention /
query ...), so a parameter's path is the same in both packages, and
`quantization.quantize_model` picks the same layers. Float linear layers are
`nn.Linear` (weight stored (out, in), the transpose of the JAX `kernel`);
after quantization they are `WOQLinear`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from intel_extension_for_transformers_tpu_torch.ops.layers import (
    attention,
    gelu,
    layer_norm,
    padding_mask,
)


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0

    @classmethod
    def tiny(cls, **kw):
        """4-layer toy config for tests."""
        base = dict(
            vocab_size=1024,
            hidden_size=128,
            num_hidden_layers=4,
            num_attention_heads=4,
            intermediate_size=256,
            max_position_embeddings=128,
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def bge_small(cls):
        return cls(hidden_size=384, num_hidden_layers=12, num_attention_heads=12,
                   intermediate_size=1536)

    @classmethod
    def bge_base(cls):
        return cls()

    @classmethod
    def bge_large(cls):
        return cls(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
                   intermediate_size=4096)


def bert_config_from_hf(hf_config) -> BertConfig:
    """Build from a transformers BertConfig-like object (read by attribute)."""
    return BertConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_hidden_layers=hf_config.num_hidden_layers,
        num_attention_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        max_position_embeddings=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        layer_norm_eps=hf_config.layer_norm_eps,
        pad_token_id=hf_config.pad_token_id or 0,
    )


class _LayerNormParams(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.ln_scale = nn.Parameter(torch.ones(h))
        self.ln_bias = nn.Parameter(torch.zeros(h))


class BertEmbeddings(_LayerNormParams):
    def __init__(self, config: BertConfig):
        super().__init__(config.hidden_size)
        h = config.hidden_size
        self.word_embeddings = nn.Parameter(torch.empty(config.vocab_size, h))
        self.position_embeddings = nn.Parameter(torch.empty(config.max_position_embeddings, h))
        self.token_type_embeddings = nn.Parameter(torch.zeros(config.type_vocab_size, h))


class BertAttention(_LayerNormParams):
    def __init__(self, config: BertConfig):
        super().__init__(config.hidden_size)
        h = config.hidden_size
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.output = nn.Linear(h, h)


class BertMLP(_LayerNormParams):
    def __init__(self, config: BertConfig):
        super().__init__(config.hidden_size)
        self.intermediate = nn.Linear(config.hidden_size, config.intermediate_size)
        self.output = nn.Linear(config.intermediate_size, config.hidden_size)


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.attention = BertAttention(config)
        self.mlp = BertMLP(config)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        c = self.config
        B, T, h = x.shape
        nh = c.num_attention_heads
        att = self.attention
        q = att.query(x).reshape(B, T, nh, h // nh)
        k = att.key(x).reshape(B, T, nh, h // nh)
        v = att.value(x).reshape(B, T, nh, h // nh)
        ctx = att.output(attention(q, k, v, mask=mask).reshape(B, T, h))
        x = layer_norm(x + ctx, att.ln_scale, att.ln_bias, c.layer_norm_eps)
        mlp = self.mlp
        y = mlp.output(gelu(mlp.intermediate(x), approximate=False))
        return layer_norm(x + y, mlp.ln_scale, mlp.ln_bias, c.layer_norm_eps)


class BertModel(nn.Module):
    """Encoder + pooler. `forward` is `bert_apply`: last hidden states (B, T, H)."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config)
        self.layers = nn.ModuleList(BertLayer(config) for _ in range(config.num_hidden_layers))
        self.pooler = nn.Linear(config.hidden_size, config.hidden_size)

    def forward(
        self,
        input_ids: torch.Tensor,  # (B, T) int
        attention_mask: Optional[torch.Tensor] = None,  # (B, T)
        token_type_ids: Optional[torch.Tensor] = None,  # (B, T)
    ) -> torch.Tensor:
        emb = self.embeddings
        input_ids = input_ids.to(torch.int64)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        T = input_ids.shape[1]
        x = (
            emb.word_embeddings[input_ids]
            + emb.position_embeddings[:T][None]
            + emb.token_type_embeddings[token_type_ids.to(torch.int64)]
        )
        x = layer_norm(x, emb.ln_scale, emb.ln_bias, self.config.layer_norm_eps)
        mask = padding_mask(attention_mask) if attention_mask is not None else None
        for layer in self.layers:
            x = layer(x, mask)
        return x


@torch.no_grad()
def bert_init_params(
    generator: torch.Generator, config: BertConfig, model_cls: type = BertModel
) -> BertModel:
    """Random init with the JAX init's shapes and scales: N(0, 0.02) tables
    and kernels, zero biases and token-type table, unit LayerNorm scales.

    Draws come from `generator` on its device, where the model is built.
    The values differ from `jax.random`'s for any seed. `model_cls` may be a
    subclass with extra layers, such as the reranker's `CrossEncoder`.
    """
    with torch.device("meta"):
        model = model_cls(config)
    model.to_empty(device=generator.device)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "ln_scale":
            p.fill_(1.0)
        elif leaf in ("ln_bias", "bias", "token_type_embeddings"):
            p.zero_()
        else:
            p.normal_(0.0, 0.02, generator=generator)
    return model


def bert_apply(
    model: BertModel,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full encoder forward → last hidden states (B, T, H)."""
    return model(input_ids, attention_mask, token_type_ids)


def bert_encode(
    model: BertModel,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    pooling: str = "cls",
    normalize: bool = True,
) -> torch.Tensor:
    """Sentence embeddings: encoder → pool (cls | mean) → L2-normalize (B, H)."""
    hidden = model(input_ids, attention_mask, token_type_ids)
    if pooling == "cls":
        emb = hidden[:, 0, :]
    elif pooling == "mean":
        if attention_mask is None:
            emb = hidden.mean(dim=1)
        else:
            m = attention_mask.to(hidden.dtype)[:, :, None]
            emb = (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-9)
    else:
        raise ValueError(f"unknown pooling {pooling!r}")
    if normalize:
        norm = torch.linalg.vector_norm(emb.to(torch.float32), dim=-1, keepdim=True)
        emb = emb / norm.clamp_min(1e-12).to(emb.dtype)
    return emb
