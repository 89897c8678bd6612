"""Data parallelism and multi-process training (port of
``pretrain_gnns_tpu.parallel``'s ``mesh``, ``dp`` and ``multihost``).

One process drives one device; ``torch.distributed`` is the transport
(NCCL on CUDA, gloo on the CPU) and the process group's world stands
where the JAX package's mesh has its ``data`` axis."""
