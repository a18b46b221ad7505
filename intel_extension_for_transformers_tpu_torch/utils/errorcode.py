"""Central error-code registry (port of the JAX package's utils/errorcode.py,
unchanged: it is pure Python).

Mirrors the reference's serving error registry
(reference: neural_chat/errorcode.py — ErrorCodes class with numeric ranges
per subsystem) so API layers can return stable machine-readable codes.
"""


class ErrorCodes:
    SUCCESS = 0

    # Model loading / building (1xxx)
    ERROR_OUT_OF_MEMORY = 1001
    ERROR_DEVICE_BUSY = 1002
    ERROR_DEVICE_NOT_FOUND = 1003
    ERROR_OUT_OF_STORAGE = 1004
    ERROR_DEVICE_NOT_SUPPORTED = 1005
    ERROR_MODEL_NOT_FOUND = 2001
    ERROR_MODEL_CONFIG_NOT_FOUND = 2002
    ERROR_TOKENIZER_NOT_FOUND = 2003
    ERROR_CACHE_DIR_NO_WRITE_PERMISSION = 2004
    ERROR_INVALID_MODEL_VERSION = 2005
    ERROR_MODEL_NOT_SUPPORTED = 2006
    WARNING_INPUT_EXCEED_MAX_SEQ_LENGTH = 2101

    # Dataset (3xxx)
    ERROR_DATASET_NOT_FOUND = 3001
    ERROR_DATASET_CONFIG_NOT_FOUND = 3002
    ERROR_VALIDATION_FILE_NOT_FOUND = 3003
    ERROR_TRAIN_FILE_NOT_FOUND = 3004
    ERROR_DATASET_CACHE_DIR_NO_WRITE_PERMISSION = 3005

    # Plugins / retrieval (4xxx)
    ERROR_RETRIEVAL_DOC_FORMAT_NOT_SUPPORTED = 4001
    ERROR_RETRIEVAL_DOC_NOT_FOUND = 4002
    ERROR_INTENT_DETECT_FAIL = 4003
    ERROR_SENSITIVE_CHECK_FAIL = 4004
    ERROR_MEMORY_CONTROL_FAIL = 4005
    ERROR_AUDIO_FORMAT_NOT_SUPPORTED = 4006
    ERROR_CACHE_OPERATION_FAIL = 4007
    ERROR_PLUGIN_NOT_SUPPORTED = 4008

    # Inference (5xxx)
    ERROR_PRECISION_NOT_SUPPORTED = 5001
    ERROR_GENERATION_FAIL = 5002
    ERROR_QUANTIZATION_FAIL = 5003

    # Generic
    ERROR_GENERIC = 9999

    error_strings = {
        SUCCESS: "succeeded",
        ERROR_OUT_OF_MEMORY: "device out of memory",
        ERROR_DEVICE_NOT_FOUND: "device not found",
        ERROR_DEVICE_NOT_SUPPORTED: "device not supported",
        ERROR_MODEL_NOT_FOUND: "model not found",
        ERROR_MODEL_NOT_SUPPORTED: "model not supported",
        ERROR_TOKENIZER_NOT_FOUND: "tokenizer not found",
        ERROR_DATASET_NOT_FOUND: "dataset not found",
        ERROR_RETRIEVAL_DOC_FORMAT_NOT_SUPPORTED: "retrieval document format not supported",
        ERROR_RETRIEVAL_DOC_NOT_FOUND: "retrieval document not found",
        ERROR_INTENT_DETECT_FAIL: "intent detection failed",
        ERROR_PLUGIN_NOT_SUPPORTED: "plugin not supported",
        ERROR_PRECISION_NOT_SUPPORTED: "precision not supported",
        ERROR_GENERATION_FAIL: "generation failed",
        ERROR_QUANTIZATION_FAIL: "quantization failed",
        ERROR_GENERIC: "generic error",
    }
