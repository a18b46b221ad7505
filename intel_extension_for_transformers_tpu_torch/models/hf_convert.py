"""HuggingFace checkpoint → the port's modules.

Port of the Llama and BERT converters of `intel_extension_for_transformers_tpu/
models/hf_convert.py`. Where the JAX package copies an HF model's state dict
into a params tree of f32 numpy arrays, these read `hf_model.config` and
`hf_model.state_dict()` straight into a `LlamaModel` / `BertModel` in f32,
on the card unless `device` names another. An HF `nn.Linear` weight is
already (out, in), the port's layout, so nothing is transposed. Neither
imports transformers: the model object is all they read.

Covered as in the JAX converter: the "model." / "bert." prefixes, tied
embeddings (copied to `lm_head`), Qwen2's q/k/v biases, Mistral's sliding
window, Phi-3's fused `qkv_proj` / `gate_up_proj`, and a BERT without a
pooler (an identity pooler). A Mixtral checkpoint raises: the MoE MLP is not
ported yet (ROADMAP queue 1, step 10). The generic decoder families
(`decoder_params_from_hf`) wait for step 5.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from intel_extension_for_transformers_tpu_torch.models.bert import (
    BertConfig,
    BertModel,
    bert_config_from_hf,
)
from intel_extension_for_transformers_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaModel,
    llama_config_from_hf,
)
from intel_extension_for_transformers_tpu_torch.utils.device import resolve_device


def _f32(t: torch.Tensor, device) -> torch.Tensor:
    """A copy in f32 on `device`: the model never shares storage with the HF one."""
    return t.detach().to(device=device, dtype=torch.float32, copy=True)


def _linear(weight: torch.Tensor, bias: Optional[torch.Tensor], device) -> nn.Linear:
    with torch.device("meta"):
        lin = nn.Linear(weight.shape[1], weight.shape[0], bias=bias is not None)
    lin.weight = nn.Parameter(_f32(weight, device))
    if bias is not None:
        lin.bias = nn.Parameter(_f32(bias, device))
    return lin


def _lin(sd: Mapping, prefix: str, device) -> nn.Linear:
    return _linear(sd[prefix + ".weight"], sd.get(prefix + ".bias"), device)


def _param(t: torch.Tensor, device) -> nn.Parameter:
    return nn.Parameter(_f32(t, device))


def _checked(model: nn.Module) -> nn.Module:
    left = [n for n, t in model.named_parameters() if t.is_meta]
    if left:
        raise ValueError(f"the checkpoint has no values for {left[:5]}")
    return model.eval()


def llama_params_from_hf(hf_model, device=None) -> tuple[LlamaModel, LlamaConfig]:
    """A transformers Llama/Mistral/Qwen2/Phi-3 causal LM → (LlamaModel, config)."""
    device = resolve_device(device)
    config = llama_config_from_hf(hf_model.config)
    with torch.device("meta"):
        model = LlamaModel(config)  # raises for a Mixtral (MoE) config
    sd = hf_model.state_dict()
    pre = "model." if any(k.startswith("model.") for k in sd) else ""

    model.embed_tokens = _param(sd[pre + "embed_tokens.weight"], device)
    model.final_norm = _param(sd[pre + "norm.weight"], device)
    head = sd["lm_head.weight"] if "lm_head.weight" in sd else sd[pre + "embed_tokens.weight"]
    model.lm_head = _linear(head, None, device)  # tied embeddings: a copy, as JAX does

    q_rows = config.num_attention_heads * config.head_dim
    kv_rows = config.num_key_value_heads * config.head_dim
    for li, layer in enumerate(model.layers):
        p = f"{pre}layers.{li}."
        layer.input_norm = _param(sd[p + "input_layernorm.weight"], device)
        layer.post_norm = _param(sd[p + "post_attention_layernorm.weight"], device)
        att, mlp = layer.attention, layer.mlp
        if p + "self_attn.qkv_proj.weight" in sd:  # Phi-3 fuses [q; k; v]
            w = sd[p + "self_attn.qkv_proj.weight"]
            att.q = _linear(w[:q_rows], None, device)
            att.k = _linear(w[q_rows : q_rows + kv_rows], None, device)
            att.v = _linear(w[q_rows + kv_rows :], None, device)
        else:
            for name in ("q", "k", "v"):
                setattr(att, name, _lin(sd, f"{p}self_attn.{name}_proj", device))
        att.o = _lin(sd, p + "self_attn.o_proj", device)
        if p + "mlp.gate_up_proj.weight" in sd:  # Phi-3 fuses [gate; up]
            gu = sd[p + "mlp.gate_up_proj.weight"]
            ffn = gu.shape[0] // 2
            mlp.gate = _linear(gu[:ffn], None, device)
            mlp.up = _linear(gu[ffn:], None, device)
        else:
            mlp.gate = _lin(sd, p + "mlp.gate_proj", device)
            mlp.up = _lin(sd, p + "mlp.up_proj", device)
        mlp.down = _lin(sd, p + "mlp.down_proj", device)
    return _checked(model), config


def bert_params_from_hf(hf_model, device=None) -> tuple[BertModel, BertConfig]:
    """A transformers BertModel (or a Bert*For* model's "bert." part) → (BertModel, config)."""
    device = resolve_device(device)
    config = bert_config_from_hf(hf_model.config)
    sd = hf_model.state_dict()
    if any(k.startswith("bert.") for k in sd):
        sd = {k[len("bert."):]: v for k, v in sd.items() if k.startswith("bert.")}
    with torch.device("meta"):
        model = BertModel(config)

    e, emb = "embeddings.", model.embeddings
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        setattr(emb, name, _param(sd[e + name + ".weight"], device))
    emb.ln_scale = _param(sd[e + "LayerNorm.weight"], device)
    emb.ln_bias = _param(sd[e + "LayerNorm.bias"], device)
    for li, layer in enumerate(model.layers):
        p = f"encoder.layer.{li}."
        att, mlp = layer.attention, layer.mlp
        for name, hf_name in (("query", "attention.self.query"), ("key", "attention.self.key"),
                              ("value", "attention.self.value"), ("output", "attention.output.dense")):
            setattr(att, name, _lin(sd, p + hf_name, device))
        att.ln_scale = _param(sd[p + "attention.output.LayerNorm.weight"], device)
        att.ln_bias = _param(sd[p + "attention.output.LayerNorm.bias"], device)
        mlp.intermediate = _lin(sd, p + "intermediate.dense", device)
        mlp.output = _lin(sd, p + "output.dense", device)
        mlp.ln_scale = _param(sd[p + "output.LayerNorm.weight"], device)
        mlp.ln_bias = _param(sd[p + "output.LayerNorm.bias"], device)
    if "pooler.dense.weight" in sd:
        model.pooler = _lin(sd, "pooler.dense", device)
    else:
        h = config.hidden_size
        model.pooler = _linear(torch.eye(h), torch.zeros(h), device)
    return _checked(model), config
