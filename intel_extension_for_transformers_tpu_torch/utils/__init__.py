from intel_extension_for_transformers_tpu_torch.utils.device import require_cuda, resolve_device
from intel_extension_for_transformers_tpu_torch.utils.error_utils import (
    clear_latest_error,
    get_latest_error,
    set_latest_error,
)
from intel_extension_for_transformers_tpu_torch.utils.errorcode import ErrorCodes

__all__ = ["require_cuda", "resolve_device", "ErrorCodes", "set_latest_error", "get_latest_error", "clear_latest_error"]
