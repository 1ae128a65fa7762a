"""PyTorch + CUDA port of rwkv_lm_ext_tpu for NVIDIA Hopper (H100).

The package mirrors the JAX package's module paths (``ops/``, ``models/``,
``checkpoint/``, ``data/``, ``infer/``, ``serve/``); each module's docstring
names its JAX counterpart. It imports torch and never jax or
rwkv_lm_ext_tpu. The hand-written kernels live in ``csrc/`` and are built
with nvcc at first use (ops/_lib.py).
"""
