"""Spatial ("sp") parallelism for JPEG2000: tiles and rows over the mesh.

Two real shardings, both wired into the product decode path
(codecs/jpeg2000/core.decode_j2k(mesh=...)):

- **tile-parallel**: a uniform tile grid's tile axis shards over "sp" — the
  distributed analog of the reference's per-tile resource pool
  (extensions/nvjpeg2k/cuda_decoder.cpp:601-640 fans tiles of one image
  over executor threads). J2K tiles reconstruct independently, so this
  path needs no collectives until the final image assembly (XLA inserts
  the gather from the output sharding).
- **row-parallel**: a single tile's inverse DWT shards its ROWS over "sp".
  The vertical lifting steps read one neighbor row across the shard
  boundary, so this is a genuine halo exchange: lax.ppermute moves the
  boundary rows between devices (ops/dwt.idwt2d_rows_sharded). Bit-exact vs the
  unsharded transform for the reversible 5/3 path.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..ops import dwt as dwt_ops


def idwt_tiles_batched(LL, bands, tile_shape: Tuple[int, int], reversible: bool):
    """[T, ...] stacked tile subbands → [T, th, tw] pixel tiles.

    dwt ops are batch-agnostic, so the tile axis is just a leading dim;
    jit + shard the tile axis to spread tiles over chips."""
    return dwt_ops.idwt2d(LL, bands, tile_shape, reversible)


def idwt_tiles_sharded(LL, bands, tile_shape: Tuple[int, int],
                       reversible: bool, mesh, axis_name: str = "sp"):
    """Tile-axis-sharded batched synthesis: LL [T, ...] and each band shard
    their leading tile axis over `axis_name`; every device reconstructs its
    own tiles with zero cross-device traffic (tiles are independent)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    shard = NamedSharding(mesh, P(axis_name))

    fn = jax.jit(
        lambda ll, bs: dwt_ops.idwt2d(ll, list(bs), tile_shape, reversible),
        in_shardings=(shard, tuple(tuple(shard for _ in lvl) for lvl in bands)),
        out_shardings=shard,
    )
    LL_s = jax.device_put(LL, shard)
    bands_s = tuple(tuple(jax.device_put(b, shard) for b in lvl)
                    for lvl in bands)
    return fn(LL_s, bands_s)


def dryrun_tile_exchange(mesh) -> None:
    """Driver validation of both sp shardings on tiny shapes:

    1. tile-parallel batched IDWT with the tile axis sharded over 'sp';
    2. row-parallel IDWT of ONE tile with ppermute halo exchange at the
       row-shard boundaries.

    Both must reconstruct the forward transform bit-exactly (5/3)."""
    sp = mesh.shape["sp"]
    rng = np.random.default_rng(0)

    # 1) tile axis sharded, independent reconstruction
    T = max(2 * sp, sp)
    th = tw = 16
    x = rng.integers(-128, 128, (T, th, tw)).astype(np.int32)
    LL, bands = dwt_ops.dwt2d(x, 2, reversible=True)
    out = idwt_tiles_sharded(LL, bands, (th, tw), True, mesh)
    out.block_until_ready()
    np.testing.assert_array_equal(np.asarray(out), x)

    # 2) one tile's rows sharded with halo exchange
    H = W = 16 * sp
    y = rng.integers(-128, 128, (H, W)).astype(np.int32)
    LL1, bands1 = dwt_ops.dwt2d(y, 2, reversible=True)
    out1 = dwt_ops.idwt2d_rows_sharded(LL1, bands1, (H, W), True, mesh)
    np.testing.assert_array_equal(np.asarray(out1), y)
