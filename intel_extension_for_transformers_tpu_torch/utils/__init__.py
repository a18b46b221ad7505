from intel_extension_for_transformers_tpu_torch.utils.device import require_cuda

__all__ = ["require_cuda"]
