from .ggml_format import (  # noqa: F401
    TensorRecord,
    read_model_file,
    write_model_file,
)
from .checkpoint import load_params, params_from_numpy  # noqa: F401
