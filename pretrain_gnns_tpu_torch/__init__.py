"""PyTorch/CUDA port of ``pretrain_gnns_tpu``.

The JAX package stays the reference; this package computes the same
functions with PyTorch on an NVIDIA GPU, with its TPU kernels rewritten
as hand-written CUDA kernels (``csrc/``). It imports torch and numpy,
never jax or anything of ``pretrain_gnns_tpu``.
"""
