from .qmatmul import dequantize, embedding_lookup, matmul  # noqa: F401
