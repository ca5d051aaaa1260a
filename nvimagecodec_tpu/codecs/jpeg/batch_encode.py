"""Batched device encode path: geometry-bucketed jitted pixel stage.

Mirror of the decode hot path (batch.py) for encoding — the analog of the
reference's nvjpeg encoder (extensions/nvjpeg/cuda_encoder.cpp:284-436),
which runs the color-convert/downsample/fDCT/quant pipeline on the GPU and
the Huffman bitstream assembly on the host:

- samples sharing (dims, channels, quality, subsampling, precision) stack
  into one batch and run ONE jitted device call: RGB→YCbCr, chroma
  downsample, fDCT+quant as a [N,64]x[64,64] f32 product (encode_pixels);
- coefficients return as int16 (half the D2H bytes of the int32 the
  quantizer produces — values are guaranteed to fit);
- the host stage (optimized-Huffman symbol counting, table build, entropy
  encode, container write) fans per-sample over a thread pool; the native
  C++ entropy encoder releases the GIL;
- host staging buffers are pooled (batch._HostBufferPool).
"""
from __future__ import annotations

import functools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from ...core.interfaces import EncodeParams, EncodeResult, JpegEncodeParams
from ...core.trace import span
from ...core.types import ProcessingStatus
from .batch import _POOL, _next_pow2
from .encode import (
    HuffTable,
    STD_AC_CHROMA,
    STD_AC_LUMA,
    STD_DC_CHROMA,
    STD_DC_LUMA,
    _entropy_encode,
    _resolve_css,
    build_encode_frame,
    count_symbols,
    encode_jpeg,
    encode_pixels,
    gen_optimal_table,
    write_jpeg,
)


@functools.lru_cache(maxsize=128)
def _encode_pixel_fn(key, batch: int):
    """Jitted batched pixel stage for one encode bucket: [B, H, W(, C)]
    uint8/uint16 → per-component [B, bh, bw, 64] int16 coefficients."""
    import jax

    jitted = {}

    def call(frame, imgs):
        if "f" not in jitted:

            def fn(x):
                import jax.numpy as jnp

                coefs = encode_pixels(x, frame, use_jax=True)
                return tuple(c.astype(jnp.int16) for c in coefs)

            jitted["f"] = jax.jit(fn)
        return jitted["f"](imgs)

    return call


def _finish_one(frame, coefs: List[np.ndarray], jp: JpegEncodeParams) -> bytes:
    """Host stage for one sample: Huffman tables + entropy + container."""
    if jp.optimized_huffman:
        try:
            from .native_encode import count_symbols_native

            dc_counts, ac_counts = count_symbols_native(frame, coefs)
        except Exception:
            dc_counts, ac_counts = count_symbols(frame, coefs)
        dc_tables = {i: gen_optimal_table(f) for i, f in dc_counts.items()}
        ac_tables = {i: gen_optimal_table(f) for i, f in ac_counts.items()}
    else:
        std = lambda t: HuffTable(list(t[0][1:]), list(t[1]))
        dc_tables = {0: std(STD_DC_LUMA)}
        ac_tables = {0: std(STD_AC_LUMA)}
        if len(frame.components) > 1:
            dc_tables[1] = std(STD_DC_CHROMA)
            ac_tables[1] = std(STD_AC_CHROMA)
    entropy = _entropy_encode(frame, coefs, dc_tables, ac_tables)
    return write_jpeg(frame, entropy, dc_tables, ac_tables)


def device_stage_auto() -> bool:
    """Whether encode runs the batched pixel stage (encode_pixels under jit)
    before the host Huffman pass, or the fused native host pipeline.
    TIC_ENCODE_DEVICE=1/0 overrides. Otherwise the batched stage is the
    default only where the "device" is this host (CPU backend: no
    transfer): with an NVIDIA H100 and a 16-core host the fused host
    pipeline encoded 375x500 images at 3526 img/s against 647 img/s for the
    device stage, whose per-sample host Huffman pass bounds it whatever the
    link rate."""
    import jax

    env = os.environ.get("TIC_ENCODE_DEVICE")
    if env is not None:
        return env not in ("0", "false", "")
    return jax.default_backend() == "cpu"


def encode_batch_device(image_batch, params: Optional[EncodeParams],
                     mesh=None) -> List[EncodeResult]:
    params = params or EncodeParams()
    jp = params.jpeg or JpegEncodeParams()
    n = len(image_batch)
    results: List[EncodeResult] = [None] * n  # type: ignore[list-item]

    import jax

    use_device = device_stage_auto()
    if not use_device and not jp.progressive:
        # host pixel stage, per-sample over the pool. The full pipeline
        # (color + downsample + fDCT/quant + Huffman) runs in native C++
        # with the GIL released; same plugin, so the priority ladder and
        # per-sample fallback semantics are unchanged.
        setup_cache: Dict[tuple, tuple] = {}

        def _host_one(img):
            a = np.asarray(img)
            if a.ndim == 3 and a.shape[-1] == 1:
                a = a[..., 0]
            if (a.dtype == np.uint8 and not jp.optimized_huffman):
                # fused single native call (color→downsample→fDCT→Huffman
                # in one MCU-row-resident pass) + cached header prefix
                try:
                    from .encode import jpeg_header_bytes
                    from .native_encode import encode_scan_fused, fused_setup

                    nchan = 1 if a.ndim == 2 else a.shape[-1]
                    ck = (a.shape, nchan)
                    cached = setup_cache.get(ck)
                    if cached is None:
                        css = _resolve_css(params, nchan)
                        frame = build_encode_frame(
                            a.shape[0], a.shape[1], nchan, params.quality,
                            css, 8)
                        for ci, c in enumerate(frame.components):
                            c.dc_tbl = c.ac_tbl = 0 if ci == 0 else 1
                        std = lambda t: HuffTable(list(t[0][1:]), list(t[1]))
                        dc_t = {0: std(STD_DC_LUMA)}
                        ac_t = {0: std(STD_AC_LUMA)}
                        if len(frame.components) > 1:
                            dc_t[1] = std(STD_DC_CHROMA)
                            ac_t[1] = std(STD_AC_CHROMA)
                        header = jpeg_header_bytes(frame, dc_t, ac_t)
                        setup = fused_setup(frame, dc_t, ac_t)
                        cached = (frame, header, setup)
                        setup_cache[ck] = cached
                    frame, header, setup = cached
                    scan = encode_scan_fused(a, frame, None, None,
                                             setup=setup)
                    return header + scan + b"\xff\xd9"
                except Exception:
                    pass
            try:
                from .native_encode import encode_pixels_native

                nchan = 1 if a.ndim == 2 else a.shape[-1]
                css = _resolve_css(params, nchan)
                frame = build_encode_frame(a.shape[0], a.shape[1], nchan,
                                           params.quality, css, 8)
                for ci, c in enumerate(frame.components):
                    c.dc_tbl = c.ac_tbl = 0 if ci == 0 else 1
                coefs = encode_pixels_native(a, frame)
                return _finish_one(frame, coefs, jp)
            except Exception:
                return encode_jpeg(a, params)  # array-path fallback

        pool = ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 2))
        try:
            futs = [pool.submit(_host_one, img) for img in image_batch]
            out = []
            for f in futs:
                try:
                    out.append(EncodeResult(ProcessingStatus.SUCCESS,
                                            f.result()))
                except Exception as e:
                    out.append(EncodeResult(ProcessingStatus.FAIL,
                                            error=str(e)))
            return out
        finally:
            pool.shutdown(wait=False)

    dp_sharding = None
    dp = 1
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        dp = mesh.shape.get("dp", 1)
        dp_sharding = NamedSharding(mesh, P("dp"))

    # progressive needs the multi-scan host scheduler — per-sample path
    if jp.progressive:
        out = []
        for img in image_batch:
            try:
                out.append(EncodeResult(
                    ProcessingStatus.SUCCESS,
                    encode_jpeg(np.asarray(img), params)))
            except Exception as e:
                out.append(EncodeResult(ProcessingStatus.FAIL, error=str(e)))
        return out

    # 1) bucket by geometry (dims, channels, dtype → same frame/jit)
    groups: Dict[tuple, list] = {}
    arrays = {}
    for i, img in enumerate(image_batch):
        try:
            a = np.asarray(img)
            if a.ndim == 3 and a.shape[-1] == 1:
                a = a[..., 0]
            if a.ndim not in (2, 3) or (a.ndim == 3 and a.shape[-1] != 3):
                raise ValueError(f"unsupported image shape {a.shape}")
            if a.dtype not in (np.uint8, np.uint16):
                raise ValueError(f"unsupported dtype {a.dtype}")
            arrays[i] = a
            groups.setdefault((a.shape, str(a.dtype)), []).append(i)
        except Exception as e:
            results[i] = EncodeResult(ProcessingStatus.FAIL, error=str(e))

    pool = ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 2))
    try:
        for (shape, dt), idxs in groups.items():
            b = len(idxs)
            bpad = max(_next_pow2(b), dp)
            nchan = 1 if len(shape) == 2 else shape[-1]
            H, W = shape[:2]
            css = _resolve_css(params, nchan)
            precision = 12 if dt == "uint16" else 8
            frame = build_encode_frame(H, W, nchan, params.quality, css,
                                       precision)
            for ci, c in enumerate(frame.components):
                c.dc_tbl = c.ac_tbl = 0 if ci == 0 else 1

            pool_key = ("enc", shape, dt, bpad)
            stage = _POOL.acquire(pool_key, (bpad,) + shape, np.dtype(dt))
            for j, i in enumerate(idxs):
                stage[j] = arrays[i]
            if bpad != b:
                stage[b:] = 0

            try:
                with span("imgcodec.jpeg.encode_device_stage"):
                    dev = jax.device_put(stage, dp_sharding)
                    jax.block_until_ready(dev)
                    _POOL.release(pool_key, stage)
                    key = (shape, dt, params.quality, int(css), precision)
                    coefs_dev = _encode_pixel_fn(key, bpad)(frame, dev)
                    # D2H: int16 coefficient planes back to the host
                    coefs_host = [np.asarray(c) for c in coefs_dev]

                with span("imgcodec.jpeg.encode_host_entropy"):
                    def _one(j_i):
                        j, i = j_i
                        coefs = [np.ascontiguousarray(
                            coefs_host[c][j].astype(np.int32))
                            for c in range(len(coefs_host))]
                        return i, _finish_one(frame, coefs, jp)

                    if b > 1:
                        futs = {pool.submit(_one, (j, i)): i
                                for j, i in enumerate(idxs)}
                        for fut, i in futs.items():
                            try:
                                _, data = fut.result()
                                results[i] = EncodeResult(
                                    ProcessingStatus.SUCCESS, data)
                            except Exception as e:
                                results[i] = EncodeResult(
                                    ProcessingStatus.FAIL, error=str(e))
                    else:
                        i, data = _one((0, idxs[0]))
                        results[i] = EncodeResult(
                            ProcessingStatus.SUCCESS, data)
            except Exception as e:
                for i in idxs:
                    if results[i] is None:
                        results[i] = EncodeResult(
                            ProcessingStatus.FAIL, error=str(e))
            for i in idxs:
                if results[i] is None:
                    results[i] = EncodeResult(
                        ProcessingStatus.FAIL, error="encode failed")
    finally:
        pool.shutdown(wait=False)
    return results
