"""The benchmark of ``biogpt_tpu_torch``, the PyTorch and CUDA port, on
one H100: ``python -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace 0|1`` (``run.py``). Its cells, configurations and
metrics are declared in ``BENCHMARK.json`` at the root of the repository.

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or the JAX package
``biogpt_tpu``; the plain reference (``configs/biogpt_ref.py``) imports
nothing of the port either.
"""
