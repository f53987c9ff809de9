from .codecs import (  # noqa: F401
    QK,
    BLOCK_SIZES,
    GGML_TYPE_F16,
    GGML_TYPE_F32,
    GGML_TYPE_Q4_0,
    GGML_TYPE_Q4_1,
    GGML_TYPE_Q5_0,
    GGML_TYPE_Q5_1,
    GGML_TYPE_Q8_0,
)
from .layouts import LEVEL_OFFSET, QuantizedTensor  # noqa: F401
