"""biogpt_tpu_torch — the PyTorch/CUDA port of biogpt_tpu for NVIDIA Hopper.

Generation from Q4_0, Q4_1, Q5_0, Q5_1 and Q8_0 model files -- the CLI's
single stream and the batched HTTP server (load -> prefill -> fused decode
-> greedy or sampled tail) -- runs on the card through hand-written CUDA
kernels (``csrc/``); every kernel has a plain PyTorch version beside it
that the CPU runs. The package imports torch and numpy only.
"""

from .config import BioGptConfig, GenerationParams  # noqa: F401
