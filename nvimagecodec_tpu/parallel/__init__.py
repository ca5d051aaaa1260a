"""Multi-chip / multi-host distribution.

The reference is a single-process, single-GPU library (SURVEY.md §2.7); its
parallelism is thread-pool fan-out + load-hint balancing. Here distribution
is first-class: batches shard over a device mesh (data parallel), J2K tiles
shard spatially (the context-parallel analog of the reference's
tile-resource pool, extensions/nvjpeg2k/cuda_decoder.cpp:601-640), and the
collectives (NCCL over NVLink between the GPUs of a host) come from
jax.sharding + shard_map.
"""
from .mesh import make_mesh, batch_sharding  # noqa: F401
