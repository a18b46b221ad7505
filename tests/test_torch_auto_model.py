"""Port parity for the model API (the port's counterpart of
tests/test_auto_model.py): tiny HF models built from local configs go through
the JAX package's `AutoModelForCausalLM` / `AutoModel` and the port's.

Tolerances: packed codes, scales and zero points are compared bit for bit;
logits within 1e-4 relative (Frobenius) — the same f32 weights and int8 /
int4 codes, with the plain versions of K1/K2 rounding as the Pallas kernels
do, summed in another order through two layers; greedy tokens exactly; a
save → reload round trip inside the port gives identical logits."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import intel_extension_for_transformers_tpu as jitx
from intel_extension_for_transformers_tpu.models.generation import SamplingConfig as JSamplingConfig
from intel_extension_for_transformers_tpu.transformers import BitsAndBytesConfig as JBitsAndBytesConfig
from intel_extension_for_transformers_tpu_torch.models import auto
from intel_extension_for_transformers_tpu_torch.models.generation import SamplingConfig
from intel_extension_for_transformers_tpu_torch.ops.quant_matmul import WOQLinear
from intel_extension_for_transformers_tpu_torch.quantization import GPTQConfig, RtnConfig
from intel_extension_for_transformers_tpu_torch.transformers import BitsAndBytesConfig

torch.set_num_threads(1)

LOGIT_REL_TOL = 1e-4
IDS = np.arange(16, dtype=np.int32)[None, :] * 7 % 256


@pytest.fixture(scope="module")
def tiny_hf_llama():
    import transformers as hf

    # hidden 256: int4 at g128 needs 128 | K/2, so every projection packs
    cfg = hf.LlamaConfig(vocab_size=256, hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, intermediate_size=512, max_position_embeddings=128)
    torch.manual_seed(0)
    return hf.LlamaForCausalLM(cfg).eval()


@pytest.fixture(scope="module")
def tiny_hf_bert():
    import transformers as hf

    cfg = hf.BertConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=128, max_position_embeddings=64)
    torch.manual_seed(0)
    return hf.BertModel(cfg).eval()


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _logits(model, ids=IDS):
    out, _ = model(ids)
    return out.float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float32)


QUANT = {
    "load_in_8bit": dict(load_in_8bit=True),
    "load_in_4bit": dict(load_in_4bit=True),
    "RtnConfig int8 asym g32": dict(quantization_config=("int8", "asym", 32)),
}


def _configs(kw):
    """The same request for both packages (an explicit config is built twice)."""
    if "quantization_config" in kw:
        wd, scheme, g = kw["quantization_config"]
        return ({"quantization_config": jitx.RtnConfig(weight_dtype=wd, scheme=scheme, group_size=g)},
                {"quantization_config": RtnConfig(weight_dtype=wd, scheme=scheme, group_size=g)})
    return kw, kw


@pytest.mark.parametrize("how", sorted(QUANT))
def test_from_hf_model_matches_jax(tiny_hf_llama, how):
    jkw, tkw = _configs(QUANT[how])
    j = jitx.AutoModelForCausalLM.from_hf_model(tiny_hf_llama, **jkw)
    t = auto.AutoModelForCausalLM.from_hf_model(tiny_hf_llama, device="cpu", **tkw)
    assert isinstance(t, auto.CausalLM)
    assert t.quantization_config.to_dict() == j.quantization_config.to_dict()
    # every packed projection: codes, scales and zero points bit for bit
    n = 0
    for li, layer in enumerate(t.params.layers):
        for block in ("attention", "mlp"):
            for name, lin in getattr(layer, block).named_children():
                jq = j.params["layers"][li][block][name]["kernel"]
                assert isinstance(lin, WOQLinear)
                for f in ("data", "scales", "zeros"):
                    a, b = getattr(lin, f), getattr(jq, f)
                    assert (a is None) == (b is None)
                    if a is not None:
                        assert np.asarray(b).tobytes() == a.numpy().tobytes(), (li, name, f)
                n += 1
    assert n == 14 and isinstance(t.params.lm_head, torch.nn.Linear)  # lm_head stays float
    assert _rel(_logits(t), _logits(j)) <= LOGIT_REL_TOL
    want = j.generate(IDS[0], JSamplingConfig(max_new_tokens=8))
    got = t.generate(IDS[0], SamplingConfig(max_new_tokens=8))
    assert got.shape == (1, 8) and np.array_equal(got, np.asarray(want))


def test_save_then_from_pretrained_round_trip(tiny_hf_llama, tmp_path):
    t = auto.AutoModelForCausalLM.from_hf_model(tiny_hf_llama, load_in_8bit=True, device="cpu")
    d = str(tmp_path / "m")
    t.save_low_bit(d)
    r = auto.AutoModelForCausalLM.from_pretrained(d, device="cpu")
    assert isinstance(r, auto.CausalLM) and r.quantization_config.to_dict() == t.quantization_config.to_dict()
    for (na, a), (nb, b) in zip(t.params.state_dict().items(), r.params.state_dict().items(), strict=True):
        assert na == nb and a.dtype == b.dtype and torch.equal(a, b), na
    assert np.array_equal(_logits(t), _logits(r))
    o = auto.OptimizedModel.from_pretrained(d, device="cpu")
    assert isinstance(o, auto.CausalLM) and np.array_equal(_logits(o), _logits(t))
    assert isinstance(auto.AutoModelForCausalLM.load_low_bit(d, device="cpu"), auto.CausalLM)
    with pytest.raises(ValueError, match="AutoModelForCausalLM|encoder"):
        auto.AutoModel.from_pretrained(d, device="cpu")


@pytest.mark.parametrize("how", ["load_in_8bit", "load_in_4bit"])
def test_jax_saved_dir_loads_in_the_port(tiny_hf_llama, tmp_path, how):
    j = jitx.AutoModelForCausalLM.from_hf_model(tiny_hf_llama, **QUANT[how])
    d = str(tmp_path / "j")
    j.save_low_bit(d)
    t = auto.AutoModelForCausalLM.from_pretrained(d, device="cpu")
    assert _rel(_logits(t), _logits(j)) <= LOGIT_REL_TOL
    want = j.generate(IDS[0], JSamplingConfig(max_new_tokens=6))
    assert np.array_equal(t.generate(IDS[0], SamplingConfig(max_new_tokens=6)), np.asarray(want))


def test_rope_scaling_survives_the_json_round_trip(tmp_path):
    """The saved config is asdict in JSON: rope_scaling comes back a list and
    must be the tuple again, or the model config differs."""
    import transformers as hf

    cfg = hf.LlamaConfig(vocab_size=256, hidden_size=64, num_hidden_layers=1, num_attention_heads=4,
                         num_key_value_heads=2, intermediate_size=128, max_position_embeddings=128,
                         rope_scaling={"rope_type": "linear", "factor": 2.0})
    torch.manual_seed(3)
    t = auto.AutoModelForCausalLM.from_hf_model(hf.LlamaForCausalLM(cfg).eval(), device="cpu")
    t.save_pretrained(str(tmp_path))
    r = auto.AutoModelForCausalLM.from_pretrained(str(tmp_path), device="cpu")
    assert r.config == t.config and r.config.rope_scaling == ("linear", 2.0)
    assert r.quantization_config is None and np.array_equal(_logits(r), _logits(t))


def test_from_pretrained_reads_an_hf_checkpoint_directory(tiny_hf_llama, tmp_path):
    """A local HF checkpoint (save_pretrained; no download) loads and quantizes in one call."""
    d = str(tmp_path / "hf")
    tiny_hf_llama.save_pretrained(d)
    t = auto.AutoModelForCausalLM.from_pretrained(d, load_in_8bit=True, device="cpu", local_files_only=True)
    j = auto.AutoModelForCausalLM.from_hf_model(tiny_hf_llama, load_in_8bit=True, device="cpu")
    assert t.tokenizer is None  # no tokenizer files beside it
    assert np.array_equal(_logits(t), _logits(j))


def test_encoder_int8_round_trip(tiny_hf_bert, tmp_path):
    enc = auto.AutoModel.from_hf_model(tiny_hf_bert, quantization_config=RtnConfig(weight_dtype="int8", group_size=32),
                                       device="cpu")
    jenc = jitx.AutoModel.from_hf_model(
        tiny_hf_bert, quantization_config=jitx.RtnConfig(weight_dtype="int8", group_size=32))
    assert isinstance(enc, auto.EncoderModel)
    ids = np.arange(10, dtype=np.int32)[None, :] % 256
    emb = enc.encode(ids)
    assert emb.shape == (1, 64)
    np.testing.assert_allclose(torch.linalg.vector_norm(emb, dim=-1).numpy(), 1.0, atol=1e-3)
    assert _rel(emb.numpy(), jenc.encode(ids)) <= LOGIT_REL_TOL
    d = str(tmp_path / "e")
    enc.save_low_bit(d)
    r = auto.OptimizedModel.from_pretrained(d, device="cpu")
    assert isinstance(r, auto.EncoderModel)
    assert torch.equal(r.encode(ids), emb)
    j = jitx.OptimizedModel.from_pretrained(d)  # the JAX package reads the port's directory
    assert _rel(emb.numpy(), j.encode(ids)) <= LOGIT_REL_TOL


def test_bits_and_bytes_config_matches_jax():
    for kw in (dict(load_in_8bit=True), dict(load_in_4bit=True), dict(load_in_4bit=True, bnb_4bit_quant_type="fp4"),
               dict(load_in_4bit=True, bnb_4bit_quant_type="int4")):
        assert BitsAndBytesConfig(**kw).to_dict() == JBitsAndBytesConfig(**kw).to_dict()
    assert auto._resolve_quant_config(None, False, True).to_dict() == BitsAndBytesConfig(load_in_8bit=True).to_dict()
    assert auto._resolve_quant_config(None, False, False) is None


def test_config_family_matches_jax():
    """Every config class: same fields, defaults and validation, same JSON."""
    from intel_extension_for_transformers_tpu.quantization import config as jconfig
    from intel_extension_for_transformers_tpu_torch.quantization import config as tconfig

    assert sorted(tconfig.QUANT_METHODS) == sorted(jconfig.QUANT_METHODS)
    for method, jcls in jconfig.QUANT_METHODS.items():
        tcls = tconfig.QUANT_METHODS[method]
        assert [f.name for f in dataclasses.fields(tcls)] == [f.name for f in dataclasses.fields(jcls)]
        assert tcls().to_dict() == jcls().to_dict()
        assert tconfig.config_from_dict(jcls().to_dict()).to_dict() == jcls().to_dict()
    with pytest.raises(ValueError):
        tconfig.GPTQConfig(damp_percent=2.0)
    with pytest.raises(ValueError):
        tconfig.RtnConfig(weight_dtype="int5")
    assert tconfig.AwqConfig(zero_point=True).scheme == "asym"
    assert tconfig.SmoothQuantConfig().weight_dtype == "int8"


def test_unported_paths_raise(tiny_hf_llama, tmp_path):
    """Paths that wait for later steps raise and name them; generate(num_beams=2),
    once among them, now runs beam search and returns the JAX model's ids."""
    t = auto.AutoModelForCausalLM.from_hf_model(tiny_hf_llama, device="cpu")
    j = jitx.AutoModelForCausalLM.from_hf_model(tiny_hf_llama)
    np.testing.assert_array_equal(t.generate(IDS[0], SamplingConfig(max_new_tokens=5), num_beams=2),
                                  np.asarray(j.generate(IDS[0], JSamplingConfig(max_new_tokens=5), num_beams=2)))
    with pytest.raises(NotImplementedError, match="step 10"):
        auto.AutoModelForSeq2SeqLM.from_pretrained("t5-small")

    class Cfg:
        model_type = "gptj"

    class Fake:
        config = Cfg()

    with pytest.raises(NotImplementedError, match="step 5"):
        auto.AutoModelForCausalLM.from_hf_model(Fake(), device="cpu")
    with pytest.raises(NotImplementedError, match="step 8"):
        auto.AutoModelForCausalLM.from_hf_model(tiny_hf_llama, quantization_config=GPTQConfig(), device="cpu")
