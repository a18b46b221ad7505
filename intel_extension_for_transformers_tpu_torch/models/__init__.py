from intel_extension_for_transformers_tpu_torch.models.bert import (
    BertConfig,
    BertModel,
    bert_apply,
    bert_encode,
    bert_init_params,
)

__all__ = ["BertConfig", "BertModel", "bert_apply", "bert_encode", "bert_init_params"]
