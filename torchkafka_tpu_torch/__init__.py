"""PyTorch/CUDA port of torchkafka_tpu: continuous-batching serving on an
NVIDIA H100.

The package mirrors ``torchkafka_tpu``'s module paths so each piece has an
obvious counterpart. It imports ``torch`` and numpy, never ``jax`` and
never the JAX package. Entry points run on CUDA unless the caller passes
``device="cpu"`` (``utils.devices.resolve_device``). The two kernels of
the serving path are hand-written CUDA C++ under ``csrc/``, built with
``nvcc`` at first use into ``_build/`` (``ops/_native.py``).
"""
