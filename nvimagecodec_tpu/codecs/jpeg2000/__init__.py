"""JPEG2000 codec backends.

Replacement for the reference's nvjpeg2k extension
(reference: extensions/nvjpeg2k/ — GPU_ONLY decoder with per-tile parallel
decode, cuda_decoder.cpp:601-640; encoder with reversible/irreversible,
code-block and progression options, cuda_encoder.cpp:272-474). Our hybrid
split: host EBCOT Tier-1 (native C++, thread pool) + array-op DWT/MCT
(numpy on the host, jax on the device)."""
from __future__ import annotations

from typing import List

import numpy as np

from ...core.interfaces import (
    DecodeParams,
    DecodeResult,
    DecoderPlugin,
    EncodeParams,
    EncodeResult,
    EncoderPlugin,
    Jpeg2kEncodeParams,
)
from ...core.types import BackendKind, Priority, ProcessingStatus
from .core import decode_j2k, encode_j2k

_J2K_MAGIC = b"\xff\x4f\xff\x51"
_JP2_MAGIC = b"\x00\x00\x00\x0cjP  "


def _is_j2k(data) -> bool:
    head = bytes(data[:12])
    return head[:4] == _J2K_MAGIC or head[:8] == _JP2_MAGIC[:8]


class Jpeg2kHybridDecoder(DecoderPlugin):
    codec = "jpeg2k"
    plugin_id = "tpu_jpeg2k_hybrid_decoder"
    backend_kind = BackendKind.HYBRID_CPU_TPU
    priority = Priority.HIGH
    num_parallel_tiles = 0  # 0 → thread-pool default
    discard_levels = 0      # reduced-resolution decode
    device_pixel_stage = True
    mesh = None  # set by the scheduler for Decoder(mesh=...): sp sharding

    def set_options(self, opts) -> None:
        # reference knob: num_parallel_tiles
        # (extensions/nvjpeg2k/cuda_decoder.cpp:178-195); discard_levels is
        # the classic J2K multi-resolution decode; device_pixel_stage=false
        # keeps the IDWT on host (skips the first jit compile of the deep
        # DWT graph)
        from ...core.options import get_bool, get_int

        self.num_parallel_tiles = get_int(opts, "num_parallel_tiles", 0)
        self.discard_levels = get_int(opts, "discard_levels", 0)
        self.device_pixel_stage = get_bool(opts, "device_pixel_stage", True)

    def can_decode(self, data_batch, info_batch, params) -> List[ProcessingStatus]:
        return [
            ProcessingStatus.SUCCESS
            if _is_j2k(d)
            else ProcessingStatus.FAIL | ProcessingStatus.CODEC_UNSUPPORTED
            for d in data_batch
        ]

    def decode_batch(self, data_batch, info_batch, params) -> List[DecodeResult]:
        import os as _os

        # None = auto: decode_j2k applies the measured H2D crossover
        # (core.device_route_auto) per stream — the device IDWT/MCT stage
        # where the link clears the bars, else the host path (the same
        # threshold design as the JPEG encode device stage)
        if not self.device_pixel_stage or _os.environ.get(
                "TIC_J2K_NO_DEVICE"):
            use_jax = False
        else:
            use_jax = None

        # True ROI: only covering tiles/code-blocks are entropy-decoded
        # (reference: nvjpeg2k region decode). ROI regions are small and
        # per-sample, so they take the host pixel stage.
        roi = (params.region
               if params.enable_roi and params.region is not None
               and self.discard_levels == 0 else None)

        def one(data):
            raw = bytes(data)
            img = decode_j2k(raw, num_threads=self.num_parallel_tiles,
                             use_jax=use_jax and roi is None,
                             discard_levels=self.discard_levels,
                             mesh=self.mesh if roi is None else None,
                             region=roi)
            # sYCC-tagged JP2 (our subsampled encodes): convert the
            # upsampled YCbCr back to RGB (the reference treats SYCC the
            # same way through its conversion stage)
            from .codestream import jp2_colorspace

            if (jp2_colorspace(raw) == 18
                    and getattr(img, "ndim", 0) == 3 and img.shape[2] == 3):
                from ...ops.color import ycbcr_to_rgb_i32

                arr = np.asarray(img)
                maxv = 65535 if arr.dtype == np.uint16 else 255
                r, g, b = ycbcr_to_rgb_i32(
                    arr[:, :, 0], arr[:, :, 1], arr[:, :, 2], maxval=maxv)
                img = np.stack([r, g, b], axis=-1).astype(arr.dtype)
            if not params.allow_any_depth and str(img.dtype) == "uint16":
                img = (img >> 8).astype(
                    np.uint8 if isinstance(img, np.ndarray) else "uint8"
                )
            return img

        # fan samples over an outer pool — each sample's T1 already fans
        # over codeblocks, so this keeps all cores busy across sample
        # boundaries (the batch analog of the reference's tile pool)
        if len(data_batch) > 1:
            import os
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(
                max_workers=min(len(data_batch), os.cpu_count() or 2)
            ) as pool:
                futs = [pool.submit(one, d) for d in data_batch]
                out = []
                for f in futs:
                    try:
                        out.append(DecodeResult(ProcessingStatus.SUCCESS, f.result()))
                    except Exception as e:
                        out.append(
                            DecodeResult(
                                ProcessingStatus.FAIL
                                | ProcessingStatus.IMAGE_CORRUPTED,
                                error=str(e),
                            )
                        )
                return out
        out = []
        for data in data_batch:
            try:
                out.append(DecodeResult(ProcessingStatus.SUCCESS, one(data)))
            except Exception as e:
                out.append(
                    DecodeResult(
                        ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED,
                        error=str(e),
                    )
                )
        return out


class Jpeg2kEncoder(EncoderPlugin):
    codec = "jpeg2k"
    plugin_id = "tpu_jpeg2k_encoder"
    backend_kind = BackendKind.HYBRID_CPU_TPU
    priority = Priority.HIGH

    def can_encode(self, image_batch, info_batch, params) -> List[ProcessingStatus]:
        out = []
        for img in image_batch:
            a = np.asarray(img)
            ok = a.dtype in (np.uint8, np.uint16) and (
                a.ndim == 2 or a.shape[-1] in (1, 3)
            )
            out.append(
                ProcessingStatus.SUCCESS
                if ok
                else ProcessingStatus.FAIL | ProcessingStatus.SAMPLE_TYPE_UNSUPPORTED
            )
        return out

    @staticmethod
    def _psnr_to_quality(target_psnr: float) -> float:
        """Map a PSNR target to the quality knob using the measured ladder
        (q40≈36 dB … q95≈57 dB, ~0.38 dB per quality step) — the role of
        target_psnr in the reference's nvjpeg2k encoder
        (extensions/nvjpeg2k/cuda_encoder.cpp:272-474)."""
        return float(min(100.0, max(1.0, 40.0 + (target_psnr - 36.0) / 0.38)))

    def encode_batch(self, image_batch, info_batch, params) -> List[EncodeResult]:
        jp = params.jpeg2k or Jpeg2kEncodeParams()
        quality = params.quality
        # explicit non-default target_psnr takes precedence (reference
        # semantics: psnr-driven rate control)
        if params.target_psnr and params.target_psnr != 50.0:
            quality = self._psnr_to_quality(params.target_psnr)
        psnr_target = (
            params.target_psnr
            if params.target_psnr and params.target_psnr != 50.0
            else None
        )
        out = []
        for img in image_batch:
            try:
                a = np.asarray(img)
                q = quality

                kw = dict(
                    reversible=jp.reversible or q >= 100,
                    levels=jp.num_resolutions - 1,
                    quality=q,
                    cblk=(jp.code_block_w, jp.code_block_h),
                    stream_type=jp.stream_type,
                    num_layers=getattr(jp, "num_layers", 1),
                    prog_order=getattr(jp, "prog_order", "LRCP"),
                    precincts=getattr(jp, "precincts", None),
                    ht=getattr(jp, "ht", False),
                    mode_switches=getattr(jp, "mode_switches", 0),
                    # single-pass rate control: target_psnr drives the
                    # DWT-domain rate allocator inside encode_j2k (ONE T1
                    # encode, like nvjpeg2k's native allocator)
                    target_psnr=(psnr_target
                                 if not jp.reversible and psnr_target
                                 and q < 100 else None),
                )
                # chroma_subsampling: RGB → BT.601 YCbCr planes, box-filter
                # chroma, encode subsampled planar components with MCT off
                # (the reference's nvjpeg2k encoder accepts 444/422/420
                # image-info subsampling, cuda_encoder.cpp:100-104)
                css = params.chroma_subsampling
                sub = None
                if css is not None and a.ndim == 3 and a.shape[2] == 3:
                    name = getattr(css, "name", str(css))
                    sub = {"CSS_420": (2, 2), "CSS_422": (2, 1),
                           "420": (2, 2), "422": (2, 1)}.get(
                        name.replace("ChromaSubsampling.", ""), None)
                if sub is not None:
                    from ...ops.color import rgb_to_ycbcr_i32
                    from ...ops.resample import (
                        downsample_h2v1,
                        downsample_h2v2,
                    )

                    maxv = 65535 if a.dtype == np.uint16 else 255
                    y, cb, cr = rgb_to_ycbcr_i32(
                        a[:, :, 0], a[:, :, 1], a[:, :, 2], maxval=maxv)
                    ds = downsample_h2v2 if sub == (2, 2) else downsample_h2v1
                    cb, cr = ds(cb), ds(cr)
                    dt = a.dtype
                    kw.pop("target_psnr", None)  # planar path: quality knob
                    data = encode_j2k(
                        [y.astype(dt), cb.astype(dt), cr.astype(dt)],
                        sub=[(1, 1), sub, sub], size=a.shape[:2],
                        colorspace="sycc", **kw)
                else:
                    data = encode_j2k(a, **kw)
                out.append(EncodeResult(ProcessingStatus.SUCCESS, data))
            except Exception as e:
                out.append(EncodeResult(ProcessingStatus.FAIL, error=str(e)))
        return out


def register(registry) -> None:
    codec = registry.codec("jpeg2k")
    codec.register_decoder(Jpeg2kHybridDecoder())
    codec.register_encoder(Jpeg2kEncoder())
