from intel_extension_for_transformers_tpu_torch.evaluation.harness import (
    evaluate_multiple_choice,
    evaluate_perplexity,
    loglikelihood,
)

__all__ = ["evaluate_multiple_choice", "evaluate_perplexity", "loglikelihood"]
