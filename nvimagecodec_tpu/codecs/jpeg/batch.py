"""Batched device decode path: geometry-bucketed jitted pixel stage.

The XLA analog of the reference's batched GPU decode
(extensions/nvjpeg/hw_decoder.cpp nvjpegDecodeBatched): samples that share a
geometry (dims + sampling + quant tables) are stacked and run through ONE
jitted pixel function — variable shapes become shape buckets instead of
per-sample dynamic dispatch (SURVEY.md §7 "Variable shapes under XLA").
Batch sizes are padded to powers of two to bound recompilation.

Hot-path design:
- buckets of restart-interval streams ship their entropy-coded segments
  and decode them on the device (_try_device_entropy); the rest take the
  host entropy stage below;
- the host stage parses headers, preallocates the stacked batch, and
  entropy-decodes each sample DIRECTLY into its batch slot from a thread
  pool (the native decoder releases the GIL);
- coefficients travel as ONE contiguous uint8 wire buffer per chunk — per
  block, a zigzag-order prefix of low bytes + the 8 high bytes of zigzag
  0..7 (72 B or less vs 128 B of int16). The device unpacks with three
  elementwise ops; the zigzag order is folded into the IDCT matrix columns
  so reordering costs nothing. Blocks whose coefficients do not fit widen
  the bucket's wire (memoized per geometry), bit-exact either way;
- transfers run on a dedicated thread in sub-batch chunks so the entropy
  decode of chunk N+1 overlaps the device_put of chunk N (the reference's
  2-page host/GPU overlap, extensions/nvjpeg/cuda_decoder.cpp:425-427);
- the device stage is one jitted call per bucket that returns a TUPLE of
  per-sample images, so splitting the batch costs zero extra dispatches;
- outputs stay on device; callers that need completion use
  jax.block_until_ready without fetching.
"""
from __future__ import annotations

import functools
import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

from ...core.interfaces import DecodeParams, DecodeResult
from ...core import trace
from ...core.trace import span
from ...core.types import ProcessingStatus
from .headers import parse_jpeg_structure
from .pixel import cmyk_to_rgb, decode_pixels, geometry_key

log = logging.getLogger(__name__)

_PACK_HEAD = 8  # zigzag positions carrying a high byte on the packed wire

# adaptive wire ladder: (luma lo_len, chroma lo_len) per packed level. Level
# 0 truncates the always-zero zigzag tail (q<=~90 corpora); any coefficient
# that does not fit bumps the bucket's geometry to the next level, memoized
# so steady-state corpora pay the re-decode once per geometry.
_WIRE_LEVELS = ((48, 32), (64, 64))
_LEVEL_MEMO: Dict[tuple, int] = {}

_LEVEL_LOCK = threading.Lock()


def _lo_lens(level: int, ncomp: int) -> tuple:
    luma, chroma = _WIRE_LEVELS[level]
    if ncomp == 1:
        return (luma,)
    if ncomp == 4:  # CMYK/YCCK: K behaves like luma
        return (luma, chroma, chroma, luma)
    return (luma,) + (chroma,) * (ncomp - 1)


class _HostBufferPool:
    """Recycles host-side staging buffers across decode calls — the analog
    of the reference's pinned-buffer recycling in
    Work::ensure_expected_buffer (src/work.h:144-169): a fresh multi-MB host
    allocation per batch is replaced by a buffer the reclaim thread hands
    back once its transfer has completed."""

    # distinct live buffers per key: once this many exist, acquire WAITS for
    # one to come back from the reclaim thread instead of allocating more
    PER_KEY_CAP = 4

    def __init__(self, max_bytes: int, per_key_cap: int = PER_KEY_CAP,
                 alloc=None):
        self._free: Dict[tuple, list] = {}
        self._live: Dict[tuple, int] = {}
        self._cond = threading.Condition()
        self._bytes = 0
        self._max = max_bytes
        self.per_key_cap = per_key_cap
        # user-pluggable host allocator (the analog of the reference's
        # pinned-allocator hook, include/nvimgcodec.h:232-302): any
        # callable (shape, dtype) -> ndarray, e.g. one backed by a pinned
        # or hugepage arena
        self._alloc = alloc or (lambda shape, dtype: np.empty(shape, dtype))

    def acquire(self, key, shape, dtype) -> np.ndarray:
        with self._cond:
            deadline = None
            while True:
                lst = self._free.get(key)
                if lst:
                    arr = lst.pop()
                    self._bytes -= arr.nbytes
                    return arr
                if self._live.get(key, 0) < self.per_key_cap:
                    self._live[key] = self._live.get(key, 0) + 1
                    break
                import time as _t

                if deadline is None:
                    deadline = _t.monotonic() + 30.0
                if not self._cond.wait(timeout=max(0.0, deadline
                                                   - _t.monotonic())):
                    # reclaim stalled (dead device?) — allocate anyway
                    self._live[key] = self._live.get(key, 0) + 1
                    break
        return self._alloc(shape, dtype)

    def release(self, key, arr: np.ndarray) -> None:
        with self._cond:
            if self._bytes + arr.nbytes <= self._max:
                self._free.setdefault(key, []).append(arr)
                self._bytes += arr.nbytes
            else:  # drop — pool is full
                self._live[key] = max(0, self._live.get(key, 1) - 1)
            self._cond.notify_all()


_POOL = _HostBufferPool(
    int(os.environ.get("TIC_HOST_POOL_MB", "512")) << 20,
    per_key_cap=int(os.environ.get("TIC_HOST_POOL_PER_KEY_CAP", "4")))


def configure_host_pool(max_mb: int = None, per_key_cap: int = None,
                        alloc=None) -> None:
    """Adjust the host staging-buffer pool policy at runtime — the
    allocator-plumbing analog of the reference's custom pinned/device
    allocator hooks (include/nvimgcodec.h:232-302).

    max_mb: total bytes the pool may retain; per_key_cap: distinct live
    buffers per (geometry, dtype) key before acquire blocks on reclaim;
    alloc: callable (shape, dtype) -> np.ndarray used for fresh buffers."""
    with _POOL._cond:
        if max_mb is not None:
            _POOL._max = int(max_mb) << 20
        if per_key_cap is not None:
            _POOL.per_key_cap = max(1, int(per_key_cap))
        if alloc is not None:
            _POOL._alloc = alloc
        _POOL._cond.notify_all()


def _wire_layout(dims, lo_lens):
    """Byte offsets of each component's lo/hi region in one sample's wire
    row. Returns (offsets, total): offsets[c] = (lo_off, hi_off)."""
    offs = []
    pos = 0
    for (bw, bh), ll in zip(dims, lo_lens):
        offs.append(pos)
        pos += bh * bw * ll
    hi_offs = []
    for (bw, bh) in dims:
        hi_offs.append(pos)
        pos += bh * bw * _PACK_HEAD
    return list(zip(offs, hi_offs)), pos


def _unpack_component(xp, wire, lo_off, hi_off, bh, bw, lo_len):
    """One component from the packed wire → zigzag-order int16 blocks
    [..., lo_len] (a truncated zigzag prefix when lo_len < 64)."""
    B = wire.shape[0]
    lo = wire[:, lo_off:lo_off + bh * bw * lo_len].reshape(B, bh, bw, lo_len)
    hi = wire[:, hi_off:hi_off + bh * bw * _PACK_HEAD].reshape(
        B, bh, bw, _PACK_HEAD).astype(xp.int8)
    head = (hi.astype(xp.int16) << 8) | lo[..., :_PACK_HEAD].astype(xp.int16)
    tail = lo[..., _PACK_HEAD:].astype(xp.int8).astype(xp.int16)
    return xp.concatenate([head, tail], axis=-1)


@functools.lru_cache(maxsize=256)
def _pixel_fn(geom_key, batch: int, fancy: bool, to_rgb: bool, to_u8: bool,
              wire: str = "wide", nchunks: int = 1, lo_lens: tuple = (),
              bitexact: bool = False):
    """Build + jit the pixel stage for one geometry bucket. Returns a tuple
    of `batch` per-sample images from a single dispatch.

    wire="wide": args = tuple of per-component [B, bh, bw, 64] int16.
    wire="packed": args = tuple of nchunks [chunk, row_bytes] uint8 wire
        buffers, concatenated on device."""
    import jax

    jitted = {}

    def call(frame, arrs):
        if "f" not in jitted:
            _, _, dims = frame.mcu_geometry()
            offsets, _ = _wire_layout(dims, lo_lens) if lo_lens else (None, 0)

            def fn(flat):
                import jax.numpy as jnp

                if wire == "packed":
                    w = flat[0] if nchunks == 1 else jnp.concatenate(
                        flat, axis=0)
                    coefs = [
                        _unpack_component(jnp, w, lo_off, hi_off, bh, bw, ll)
                        for (lo_off, hi_off), (bw, bh), ll in zip(
                            offsets, dims, lo_lens)
                    ]
                else:
                    coefs = list(flat)
                imgs = decode_pixels(frame, coefs, use_jax=True, fancy=fancy,
                                     zigzag=(wire == "packed"),
                                     bitexact=bitexact)
                if to_rgb and imgs.ndim == 4 and imgs.shape[-1] == 4:
                    imgs = cmyk_to_rgb(imgs, jnp)
                if to_u8 and frame.precision > 8:
                    imgs = (imgs >> (frame.precision - 8)).astype(jnp.uint8)
                return tuple(imgs[j] for j in range(batch))

            jitted["f"] = jax.jit(fn)
        return jitted["f"](arrs)

    return call


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


# persistent executors: entropy fan-out, the ordered transfer queue, and the
# deferred-reclaim thread (waits for in-flight H2D copies and returns wire
# buffers to the pool WITHOUT blocking the decode caller — the analog of the
# reference's per-device stream completion callbacks recycling pinned
# buffers, src/work.h:144-169). Created lazily so importing the package
# never spins up threads.
_EXEC_LOCK = threading.Lock()
_EXECS: Dict[str, ThreadPoolExecutor] = {}


def _shared_pool(name: str, workers: int) -> ThreadPoolExecutor:
    with _EXEC_LOCK:
        p = _EXECS.get(name)
        if p is None:
            p = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix=f"tic-{name}")
            _EXECS[name] = p
        return p


def _reclaim_async(devs, pool_key, buf) -> None:
    """Return a host staging buffer to the pool once the device owns the
    bytes. Runs on the reclaim thread so decode() never waits on H2D."""
    import jax

    def _job():
        try:
            jax.block_until_ready(devs)
        finally:
            _POOL.release(pool_key, buf)

    _shared_pool("reclaim", 1).submit(_job)


# ---------------------------------------------------------------------------
# On-device entropy decode route (restart-interval streams): the host only
# splits each scan at its restart markers and the Pallas kernel
# (ops/pallas_entropy.py) Huffman-decodes the segments, feeding the same
# pixel stage inside one jit — the reference's optional GPU Huffman stage
# (extensions/nvjpeg/cuda_decoder.cpp:425-427).
# ---------------------------------------------------------------------------

# below this many same-table samples a bucket stays on the host entropy
# stage: every pow2 bucket size compiles its own kernel
_MIN_BATCH = 16
_W_MEMO: Dict[tuple, int] = {}  # dek -> compiled words height (grows only)


@functools.lru_cache(maxsize=128)
def _device_entropy_fn(dek, batch: int, W: int, S: int, nsegs: int,
                       fancy: bool, to_rgb: bool, to_u8: bool,
                       bitexact: bool, mesh=None):
    """Jitted kernel+reassemble+pixel stage for one (tables, geometry)
    bucket: words [W, S] uint32 + seg_mcus [S] int32 -> `batch` images
    + per-lane error flags, one dispatch.

    mesh: shard the LANE axis of the entropy kernel over "dp" via
    shard_map — every device Huffman-decodes its own slice of segments."""
    import jax

    jitted = {}

    def call(frame, words_dev, mcus_dev):
        if "f" not in jitted:
            from jax.sharding import PartitionSpec as _P

            from ...ops.pallas_entropy import (
                _build_kernel,
                entropy_kernel_spec,
            )
            from .device_entropy import reassemble_components

            R, comp_map, tables, _ = entropy_kernel_spec(frame)
            # the Pallas interpreter exists for the CPU backend only; on a
            # GPU the kernel compiles or the call fails
            interp = jax.devices()[0].platform == "cpu"
            dp = mesh.shape.get("dp", 1) if mesh is not None else 1
            kfn = _build_kernel(R, comp_map, tables, W, S // dp, interp)
            if dp > 1:
                # pallas outputs carry no vma/replication annotations
                kfn = jax.shard_map(
                    kfn, mesh=mesh, in_specs=(_P(None, "dp"), _P("dp")),
                    out_specs=(_P("dp"), _P("dp")), check_vma=False)

            def fn(words, seg_mcus):
                import jax.numpy as jnp

                out, err = kfn(words, seg_mcus)
                coefs = reassemble_components(jnp, out, frame, batch, nsegs)
                imgs = decode_pixels(frame, coefs, use_jax=True, fancy=fancy,
                                     zigzag=True, bitexact=bitexact)
                if to_rgb and imgs.ndim == 4 and imgs.shape[-1] == 4:
                    imgs = cmyk_to_rgb(imgs, jnp)
                if to_u8 and frame.precision > 8:
                    imgs = (imgs >> (frame.precision - 8)).astype(jnp.uint8)
                return tuple(imgs[j] for j in range(batch)) + (err,)

            jitted["f"] = jax.jit(fn)
        return jitted["f"](words_dev, mcus_dev)

    return call


def _lane_plan(nsegs: int, ngood: int, dp: int):
    """(ch, S): images per kernel call (pow2, for shape reuse) and the lane
    count, padded so every device's shard is whole lane tiles."""
    from ...ops.pallas_entropy import LANE_TILE

    ch = _next_pow2(ngood)
    mult = LANE_TILE * dp
    return ch, -(-ch * nsegs // mult) * mult


def _split_dri(good, frames, raws, dek, nsegs, pool, dp):
    """Restart-marker split of the whole bucket into one [W, S] matrix.
    Returns (ch, W, S, words, seg_mcus, bad) or None; bad holds positions
    in `good` whose restart structure did not split as expected (host
    path)."""
    from .device_entropy import split_batch_segments

    scan_words = max(
        (frames[i].scans[0].data_end - frames[i].scans[0].data_start) // 4
        for i in good)
    W = max(_W_MEMO.get(dek, 0), -(-(scan_words // nsegs * 2 + 16) // 256)
            * 256)
    ch, S = _lane_plan(nsegs, len(good), dp)
    step = max(1, -(-len(good) // 16))
    chunks = [(lo, min(len(good), lo + step))
              for lo in range(0, len(good), step)]
    while True:  # retry the bucket when a segment exceeds W words
        wkey = ("segwords", W, S)
        words = _POOL.acquire(wkey, (W, S), np.uint32)
        seg_mcus = np.zeros(S, np.int32)

        def _one(lohi, words=words, seg_mcus=seg_mcus):
            lo, hi = lohi
            return split_batch_segments(
                [frames[i] for i in good[lo:hi]],
                [raws[i] for i in good[lo:hi]], W, lanes=S, words=words,
                first=lo, seg_mcus=seg_mcus)

        packs = (list(pool.map(_one, chunks)) if pool is not None
                 else [_one(c) for c in chunks])
        if all(p is not None for p in packs):
            break
        _POOL.release(wkey, words)
        if W > scan_words + 256:
            return None  # no segment can outgrow its scan: malformed
        W = -(-(W * 2) // 256) * 256
    _W_MEMO[dek] = W
    bad = sorted(lo + j for (lo, _), p in zip(chunks, packs) for j in p[3])
    return ch, W, S, words, seg_mcus, bad


def _try_device_entropy(idxs, frames, raws, results, fancy, to_rgb, to_u8,
                        bitexact, xfer, deferred, pool=None, mesh=None):
    """Decode a geometry bucket of restart-interval streams through the
    on-device entropy kernel. Returns the list of sample indices it could
    NOT handle (mixed tables, malformed restart structure) — those
    continue down the host entropy path — or None to decline the whole
    bucket. The pending error-flag fetch goes to `deferred`; the caller
    re-decodes flagged samples on the host path."""
    import jax

    from .device_entropy import device_entropy_plan

    f0 = frames[idxs[0]]
    plan = device_entropy_plan(f0)
    if plan is None:
        return None
    good = [i for i in idxs if i == idxs[0]
            or device_entropy_plan(frames[i]) == plan]
    if len(good) < _MIN_BATCH:
        return None
    if len(good) * 2 < len(idxs):
        return None  # mostly mixed tables: bucket as one host batch instead
    leftover = [i for i in idxs if i not in set(good)]
    dek, nsegs = plan

    dp = mesh.shape.get("dp", 1) if mesh is not None else 1
    lane_shard = mcus_shard = None
    if dp > 1:
        from jax.sharding import NamedSharding, PartitionSpec as _P

        lane_shard = NamedSharding(mesh, _P(None, "dp"))
        mcus_shard = NamedSharding(mesh, _P("dp"))
    with span("imgcodec.jpeg.device_entropy_split"):
        split = _split_dri(good, frames, raws, dek, nsegs, pool, dp)
    if split is None:
        return None
    ch, W, S, words, seg_mcus, bad = split
    leftover.extend(good[j] for j in bad)
    trace.add_count("imgcodec.jpeg.h2d_bytes", words.nbytes + seg_mcus.nbytes)

    call = _device_entropy_fn(dek, ch, W, S, nsegs, fancy, to_rgb, to_u8,
                              bitexact, mesh=mesh)
    with span("imgcodec.jpeg.device_entropy_kernel"):
        wdev = xfer.submit(jax.device_put, words, lane_shard).result()
        mdev = xfer.submit(jax.device_put, seg_mcus, mcus_shard).result()
        res = call(f0, wdev, mdev)
    _reclaim_async((wdev, mdev), ("segwords", W, S), words)
    imgs, err = res[:-1], res[-1]
    bad = set(bad)
    for j, i in enumerate(good):
        if j not in bad:
            results[i] = DecodeResult(ProcessingStatus.SUCCESS, imgs[j])
    # the host only split at restart markers without decoding, so the
    # kernel's per-lane error flags are the validation. Results are final
    # unless flagged: the flags are fetched on a background thread while
    # later buckets run, and the caller re-decodes flagged samples on the
    # host path before returning.
    deferred.append((_shared_pool("errchk", 1).submit(np.asarray, err),
                     good, bad, nsegs))
    return leftover


def _chunk_plan(bpad: int) -> int:
    """Number of transfer chunks for a bucket of bpad samples: only split
    buckets big enough that the entropy decode of chunk N+1 overlapping
    the transfer of chunk N wins back the extra per-transfer cost."""
    env = os.environ.get("TIC_XFER_CHUNKS")
    if env:
        n = max(1, int(env))
    else:
        n = 2 if bpad >= 32 else 1
    while bpad % n:
        n -= 1
    return n


def decode_batch_device(data_batch, params: DecodeParams, fancy: bool = True,
                     mesh=None, bitexact: bool = False,
                     device_entropy: bool = True) -> List[DecodeResult]:
    """mesh: optional jax.sharding.Mesh — wire buffers and the pixel stage
    shard the batch axis over "dp" (data parallel over images, the
    distributed analog of the reference's executor fan-out over samples,
    src/default_executor.cpp:45-65). Bit-exact vs the single-device path.
    device_entropy=False (or TIC_NO_DEVICE_ENTROPY=1) keeps every bucket on
    the host entropy stage."""
    n = len(data_batch)
    results: List[DecodeResult] = [None] * n  # type: ignore[list-item]

    dp_sharding = None
    dp = 1
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        dp = mesh.shape.get("dp", 1)
        dp_sharding = NamedSharding(mesh, P("dp"))

    from . import _entropy_decode  # late import to avoid cycle

    try:
        from .native import (
            decode_coefficients_into,
            decode_coefficients_packed_into,
            pack_coefficients_into,
        )

        have_native = True
    except Exception:
        have_native = False

    import jax

    # 1) host: parse headers, bucket by geometry — parsing fans over the
    #    pool in chunks (it ran serially on the main thread, ~0.1 ms/img
    #    of the 2-core budget at headline rates)
    nthreads = min(32, os.cpu_count() or 2)
    pool = _shared_pool("entropy", nthreads) if n > 1 else None
    frames = {}
    groups: Dict[tuple, list] = {}
    raws = {}

    def _parse_range(lo, hi):
        out = []
        for i in range(lo, hi):
            try:
                raw = bytes(data_batch[i])
                out.append((i, raw, parse_jpeg_structure(raw), None))
            except Exception as e:
                out.append((i, None, None, str(e)))
        return out

    if pool is not None and n >= 32:
        chunk = max(16, -(-n // nthreads))
        futs = [pool.submit(_parse_range, lo, min(n, lo + chunk))
                for lo in range(0, n, chunk)]
        parsed = [t for f in futs for t in f.result()]
    else:
        parsed = _parse_range(0, n)
    for i, raw, frame, err in parsed:
        if err is not None:
            results[i] = DecodeResult(
                ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED,
                error=err)
            continue
        frames[i] = frame
        raws[i] = raw
        groups.setdefault(geometry_key(frame), []).append(i)

    # 2) per bucket: preallocated batch arrays, threaded entropy decode into
    #    slots, chunked async H2D, then one jitted device call
    xfer = _shared_pool("xfer", 1)  # ordered transfer queue
    try:
        from ...core.types import ColorSpec as _CS

        cs = getattr(params, "color_spec", None)
        to_rgb = not (cs is not None and int(cs) == int(_CS.UNCHANGED))
        to_u8 = not params.allow_any_depth
        deferred = []  # async DRI error-flag fetches (validated at the end)

        for key, idxs in groups.items():
            frame0 = frames[idxs[0]]

            # restart-interval streams: entropy decode on the device —
            # with Decoder(mesh=) the kernel's lane axis shards over "dp"
            if (have_native and device_entropy
                    and not os.environ.get("TIC_NO_DEVICE_ENTROPY")):
                left = _try_device_entropy(
                    idxs, frames, raws, results, fancy, to_rgb, to_u8,
                    bitexact, xfer, deferred, pool=pool, mesh=mesh)
                if left is not None:
                    if not left:
                        continue
                    idxs = left  # stragglers continue on the host path

            ncomp = len(frame0.components)
            b = len(idxs)
            bpad = max(_next_pow2(b), dp)  # dp shards need equal rows
            _, _, dims = frame0.mcu_geometry()
            # packed wire for everyone: baseline streams write it directly
            # at scan time; progressive streams decode wide (refinement
            # needs int16 read-modify-write) and pack after — the wire win
            # is H2D bytes either way (72 or 56 B/block vs 128)
            can_pack = (have_native
                        and not os.environ.get("TIC_NO_PACKED_WIRE"))
            with _LEVEL_LOCK:
                level = _LEVEL_MEMO.get(key, 0)
            if not can_pack:
                level = len(_WIRE_LEVELS)  # wide

            failed = set()

            def _run_fills(todo, fill):
                if pool is not None and len(todo) > 1:
                    futs = {pool.submit(fill, ji): ji[1] for ji in todo}
                    for f, i in futs.items():
                        try:
                            f.result()
                        except Exception as e:
                            failed.add(i)
                            results[i] = DecodeResult(
                                ProcessingStatus.FAIL
                                | ProcessingStatus.IMAGE_CORRUPTED,
                                error=str(e),
                            )
                else:
                    for ji in todo:
                        try:
                            fill(ji)
                        except Exception as e:
                            failed.add(ji[1])
                            results[ji[1]] = DecodeResult(
                                ProcessingStatus.FAIL
                                | ProcessingStatus.IMAGE_CORRUPTED,
                                error=str(e),
                            )

            def _attempt_packed(level):
                """Entropy-decode the bucket onto the packed wire at the
                given truncation level, streaming chunks to the device.
                Returns (xfer_futs, wire_buf, lo_lens) or None if a
                coefficient did not fit (caller widens the wire)."""
                lo_lens = _lo_lens(level, ncomp)
                offsets, row_bytes = _wire_layout(dims, lo_lens)
                pool_key = ("wire", key, bpad, lo_lens)
                wire_buf = _POOL.acquire(pool_key, (bpad, row_bytes),
                                         np.uint8)
                if bpad != b:
                    wire_buf[b:] = 0
                overflow = [False]

                def _fill(j_i):
                    j, i = j_i
                    row = wire_buf[j]
                    lo_slots, hi_slots = [], []
                    for c, (bw, bh) in enumerate(dims):
                        lo_off, hi_off = offsets[c]
                        ll = lo_lens[c]
                        lo_slots.append(
                            row[lo_off:lo_off + bh * bw * ll]
                            .reshape(bh, bw, ll))
                        hi_slots.append(
                            row[hi_off:hi_off + bh * bw * _PACK_HEAD]
                            .view(np.int8).reshape(bh, bw, _PACK_HEAD))
                    if frames[i].is_progressive or frames[i].marker == 0xC9:
                        # refinement scans (and arithmetic streams) need
                        # the int16 wide decode: into scratch, then pack
                        # onto the same wire
                        scratch = [np.empty((bh, bw, 64), np.int16)
                                   for (bw, bh) in dims]
                        decode_coefficients_into(frames[i], raws[i], scratch)
                        for c in range(ncomp):
                            if not pack_coefficients_into(
                                    scratch[c], lo_slots[c], hi_slots[c]):
                                overflow[0] = True
                    else:
                        rc = decode_coefficients_packed_into(
                            frames[i], raws[i], lo_slots, hi_slots)
                        if rc != 0:
                            overflow[0] = True
                    return i

                # sharded puts scatter the whole wire to the mesh in one go
                nchunks = 1 if dp_sharding is not None else _chunk_plan(bpad)
                chunk = bpad // nchunks
                xfer_futs = []
                for g in range(nchunks):
                    lo_j, hi_j = g * chunk, (g + 1) * chunk
                    _run_fills(
                        [(j, i) for j, i in enumerate(idxs)
                         if lo_j <= j < hi_j],
                        _fill,
                    )
                    if overflow[0]:
                        break
                    # ship this chunk while the next one entropy-decodes
                    trace.add_count("imgcodec.jpeg.h2d_bytes",
                                    wire_buf[lo_j:hi_j].nbytes)
                    xfer_futs.append(xfer.submit(
                        jax.device_put, wire_buf[lo_j:hi_j],
                        dp_sharding))
                if overflow[0]:
                    stale = tuple(f.result() for f in xfer_futs)
                    _reclaim_async(stale, pool_key, wire_buf)
                    return None
                return xfer_futs, wire_buf, lo_lens, nchunks, pool_key

            def _fill_wide(j_i):
                j, i = j_i
                slots = [coef_arrays[c][j] for c in range(ncomp)]
                if have_native:
                    decode_coefficients_into(frames[i], raws[i], slots)
                else:
                    coefs = _entropy_decode(frames[i], raws[i])
                    for c in range(ncomp):
                        slots[c][...] = coefs[c]
                return i

            host_span = span("imgcodec.jpeg.host_entropy")
            host_span.__enter__()
            attempt = None
            while attempt is None and level < len(_WIRE_LEVELS):
                failed.clear()
                attempt = _attempt_packed(level)
                if attempt is None:
                    level += 1
                    with _LEVEL_LOCK:
                        _LEVEL_MEMO[key] = level
            coef_arrays = None
            if attempt is None:
                # wide wire: progressive streams, packed overflow at every
                # level, or the pure-python fallback
                coef_arrays = [
                    _POOL.acquire(("coef", key, bpad, c),
                                  (bpad, bh, bw, 64), np.int16)
                    for c, (bw, bh) in enumerate(dims)
                ]
                if bpad != b:
                    for a in coef_arrays:
                        a[b:] = 0
                failed.clear()
                _run_fills(list(enumerate(idxs)), _fill_wide)
            host_span.__exit__(None, None, None)

            try:
                with span("imgcodec.jpeg.device_pixel_stage"):
                    if attempt is not None:
                        xfer_futs, wire_buf, lo_lens, nchunks, pool_key = attempt
                        devs = tuple(f.result() for f in xfer_futs)
                        # buffer goes back to the pool once the device owns
                        # the bytes — on the reclaim thread, not here
                        _reclaim_async(devs, pool_key, wire_buf)
                        call = _pixel_fn(key, bpad, fancy, to_rgb, to_u8,
                                         "packed", nchunks, lo_lens,
                                         bitexact)
                        imgs = call(frame0, devs)
                    else:
                        trace.add_count(
                            "imgcodec.jpeg.h2d_bytes",
                            sum(a.nbytes for a in coef_arrays))
                        devs = tuple(
                            xfer.submit(jax.device_put, a,
                                        dp_sharding).result()
                            for a in coef_arrays
                        )
                        for c, a in enumerate(coef_arrays):
                            _reclaim_async(devs, ("coef", key, bpad, c), a)
                        coef_arrays = None
                        call = _pixel_fn(key, bpad, fancy, to_rgb, to_u8,
                                         bitexact=bitexact)
                        imgs = call(frame0, devs)
                for j, i in enumerate(idxs):
                    if i in failed:
                        continue
                    results[i] = DecodeResult(ProcessingStatus.SUCCESS, imgs[j])
            except Exception as e:
                for i in idxs:
                    if i not in failed:
                        results[i] = DecodeResult(
                            ProcessingStatus.FAIL, error=str(e)
                        )
            finally:
                if coef_arrays is not None:
                    for c, a in enumerate(coef_arrays):
                        _POOL.release(("coef", key, bpad, c), a)
    finally:
        pass  # shared executors persist across calls

    # deferred DRI validation: read the per-lane error flags (fetched on a
    # background thread, overlapped with later buckets) and re-issue any
    # flagged sample through the host entropy path
    flagged = []
    for fut, sub, bad, nsegs in deferred:
        errs_np = fut.result()
        for j, i in enumerate(sub):
            if j not in bad and errs_np[j * nsegs:(j + 1) * nsegs].any():
                flagged.append(i)
    if flagged:
        redo = decode_batch_device([data_batch[i] for i in flagged], params,
                                fancy, mesh, bitexact, device_entropy=False)
        for i, r in zip(flagged, redo):
            results[i] = r
    return results
