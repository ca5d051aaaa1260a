"""Input-pipeline integration: decode batches straight onto the device mesh.

The production consumption pattern for a device image codec is a training/
serving input pipeline: encoded bytes stream in on the host, decoded pixel
batches come out as (optionally sharded) jax.Arrays with the decode of batch
N+1 overlapping the device compute of batch N (the 2-page pipeline analog,
extensions/nvjpeg/cuda_decoder.cpp:425-427)."""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from .api import Decoder
from .core.interfaces import DecodeParams


def decode_batches(
    stream_batches: Iterable[Sequence[bytes]],
    params: Optional[DecodeParams] = None,
    decoder: Optional[Decoder] = None,
    mesh=None,
    drop_failed: bool = True,
    depth: int = 2,
) -> Iterator[list]:
    """Yield lists of decoded images (device arrays) per input batch of
    encoded byte strings, pipelined `depth` batches deep: decode() calls for
    upcoming batches run on prefetch threads, so batch N's transfer/dispatch
    tail (which blocks off-GIL on the device link) overlaps batch N+1's host
    entropy stage. Completion is forced one batch late, like the reference's
    2-page host/GPU pipeline (extensions/nvjpeg/cuda_decoder.cpp:425-427).

    With `mesh`, same-shape batches are additionally stacked and sharded
    over the mesh's "dp" axis.
    """
    import jax

    dec = decoder or Decoder()
    params = params or DecodeParams()

    def _one(batch):
        outs = dec.decode(list(batch), params)
        if drop_failed:
            outs = [o for o in outs if o is not None]
        if mesh is not None and outs:
            from jax.sharding import NamedSharding, PartitionSpec as P

            arrs = [o.array for o in outs]
            if len({tuple(a.shape) for a in arrs}) == 1:
                import jax.numpy as jnp

                stacked = jnp.stack([jnp.asarray(a) for a in arrs])
                outs = jax.device_put(stacked, NamedSharding(mesh, P("dp")))
        return outs

    def _force(outs):
        from .core.trace import span

        if not isinstance(outs, list):
            with span("imgcodec.pipeline.device_wait"):
                jax.block_until_ready(outs)
            return outs
        # the device queue is in-order: completion of the batch's LAST
        # dispatched array implies the whole batch (each per-array block is
        # a separate device-link roundtrip, so blocking all 64 costs ~64x)
        for o in reversed(outs):
            a = o.array if hasattr(o, "array") else o
            if a is not None and not isinstance(a, np.ndarray):
                with span("imgcodec.pipeline.device_wait"):
                    jax.block_until_ready(a)
                break
        return outs

    depth = max(1, depth)
    if depth == 1:
        for batch in stream_batches:
            yield _force(_one(batch))
        return

    ex = ThreadPoolExecutor(max_workers=depth,
                            thread_name_prefix="tic-pipeline")
    try:
        futs: deque = deque()
        it = iter(stream_batches)
        done = False
        while True:
            while not done and len(futs) < depth:
                try:
                    futs.append(ex.submit(_one, next(it)))
                except StopIteration:
                    done = True
            if not futs:
                break
            yield _force(futs.popleft().result())
    finally:
        ex.shutdown(wait=False)
