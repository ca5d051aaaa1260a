"""Mesh construction and sharding helpers.

Replaces the communication layer the reference does not have (no
NCCL/MPI/Gloo — SURVEY.md §2.7): we use jax.sharding over a Mesh with axes

- "dp": data parallel over images in a batch (the analog of the reference's
  executor fan-out over samples, src/default_executor.cpp:45-65)
- "sp": spatial/tile parallel within one image (the analog of the J2K
  tile-resource pool, extensions/nvjpeg2k/cuda_decoder.cpp:601-640)

Multi-host initialization goes through jax.distributed. On one host of four
NVLink-joined GPUs every card reaches every other at the same rate, so the
mesh follows the work alone (XLA hands the collectives to NCCL).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def make_mesh(
    dp: Optional[int] = None,
    sp: int = 1,
    devices: Optional[Sequence] = None,
):
    """Build a ("dp", "sp") mesh over the available devices."""
    import jax
    from jax.sharding import Mesh

    devs = list(devices) if devices is not None else jax.devices()
    n = len(devs)
    if dp is None:
        dp = n // sp
    assert dp * sp <= n, f"mesh {dp}x{sp} needs more than {n} devices"
    arr = np.array(devs[: dp * sp]).reshape(dp, sp)
    return Mesh(arr, ("dp", "sp"))


def batch_sharding(mesh, batch_axis: int = 0):
    """NamedSharding placing the batch dim on 'dp', replicated over 'sp'."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = [None] * (batch_axis + 1)
    spec[batch_axis] = "dp"
    return NamedSharding(mesh, P(*spec))


def plane_sharding(mesh, batch_axis: bool = True):
    """Shard [B, H, W...] with batch on 'dp' and rows on 'sp' (spatial)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    if batch_axis:
        return NamedSharding(mesh, P("dp", "sp"))
    return NamedSharding(mesh, P("sp"))


def replicated(mesh):
    from jax.sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(mesh, P())
