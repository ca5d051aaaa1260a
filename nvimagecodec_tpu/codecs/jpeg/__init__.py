"""JPEG codec backends.

Replacement for the reference's nvjpeg extension
(reference: extensions/nvjpeg/ — HW/CUDA/lossless decoders + CUDA encoder,
priority ladder at nvjpeg_ext.cpp:42-47). Our ladder:

- `tpu_jpeg_hybrid_decoder` (HYBRID_CPU_TPU, HIGH): host entropy decode
  (native C++ when built, Python fallback) + jitted device pixel stage — the
  analog of nvjpeg's hybrid CPU-Huffman/GPU pipeline
  (extensions/nvjpeg/cuda_decoder.cpp:425-427).
- `cpu_jpeg_decoder` (CPU_ONLY, NORMAL): same entropy + numpy pixel stage —
  the analog of the libjpeg_turbo fallback extension.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ...core.interfaces import (
    DecodeParams,
    DecodeResult,
    DecoderPlugin,
    EncodeParams,
    EncodeResult,
    EncoderPlugin,
)
from ...core.types import BackendKind, ColorSpec, Priority, ProcessingStatus
from .headers import JpegFrame, parse_jpeg_structure
from .pixel import cmyk_to_rgb, decode_pixels


def _entropy_decode(frame: JpegFrame, data: bytes):
    """Native C++ entropy decoder when available, Python reference otherwise."""
    try:
        from .native import decode_coefficients_native

        return decode_coefficients_native(frame, data)
    except Exception:
        from .entropy_py import decode_coefficients

        return decode_coefficients(frame, data)


def _supported(frame: JpegFrame) -> ProcessingStatus:
    if frame.is_lossless:
        return ProcessingStatus.FAIL | ProcessingStatus.ENCODING_UNSUPPORTED
    if frame.marker in (0xCB, 0xCD, 0xCE, 0xCF, 0xC5, 0xC6, 0xC7):
        # differential / lossless-arithmetic stay unsupported; sequential
        # and progressive arithmetic (0xC9/0xCA) decode natively
        return ProcessingStatus.FAIL | ProcessingStatus.ENCODING_UNSUPPORTED
    if frame.precision not in (8, 12):
        return ProcessingStatus.FAIL | ProcessingStatus.SAMPLE_TYPE_UNSUPPORTED
    if len(frame.components) not in (1, 3, 4):
        return ProcessingStatus.FAIL | ProcessingStatus.NUM_CHANNELS_UNSUPPORTED
    return ProcessingStatus.SUCCESS


_SUPPORTED_ENCODINGS = {0xC0, 0xC1, 0xC2, 0xC9, 0xCA}  # Huffman + arithmetic (T.81 Annex K)


def _roi_ok(info, params) -> bool:
    """Codec-level ROI is only sound when the region coordinates are in
    stream space — an EXIF-rotated image whose orientation will be applied
    afterwards must decode fully and crop at the API layer."""
    if not (params.enable_roi and params.region is not None):
        return False
    if not params.apply_exif_orientation:
        return True
    o = getattr(info, "orientation", None)
    return o is None or int(o) == 1  # Orientation.NORMAL


class _JpegDecoderBase(DecoderPlugin):
    codec = "jpeg"
    use_jax = False
    bitexact = False  # integer islow IDCT: byte-exact vs libjpeg-turbo

    def can_decode(self, data_batch, info_batch, params) -> List[ProcessingStatus]:
        # Judge from the already-parsed ImageInfo (cached by CodeStream) —
        # re-parsing the full structure here doubled the host cost of the
        # hot path (reference likewise reuses parsed stream info in
        # canDecode, extensions/nvjpeg/cuda_decoder.cpp:124-174).
        out = []
        for data, info in zip(data_batch, info_batch):
            try:
                if info is None or info.codec != "jpeg":
                    frame = parse_jpeg_structure(bytes(data))
                    out.append(_supported(frame))
                    continue
                enc = int(info.jpeg_encoding)
                if enc not in _SUPPORTED_ENCODINGS:
                    out.append(
                        ProcessingStatus.FAIL
                        | ProcessingStatus.ENCODING_UNSUPPORTED
                    )
                elif info.planes and info.planes[0].precision not in (0, 8, 12):
                    out.append(
                        ProcessingStatus.FAIL
                        | ProcessingStatus.SAMPLE_TYPE_UNSUPPORTED
                    )
                elif info.num_planes not in (1, 3, 4):
                    out.append(
                        ProcessingStatus.FAIL
                        | ProcessingStatus.NUM_CHANNELS_UNSUPPORTED
                    )
                else:
                    out.append(ProcessingStatus.SUCCESS)
            except Exception:
                out.append(ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED)
        return out

    def _decode_one(self, data: bytes, params: DecodeParams,
                    roi_ok: bool = True):
        frame = parse_jpeg_structure(data)
        img = None
        if roi_ok and params.enable_roi and params.region is not None:
            # True ROI: entropy-skip + windowed pixel stage (reference: nvjpeg
            # ROI, extensions/nvjpeg/cuda_decoder.cpp:460-520). Falls back to
            # full decode (API-level crop) on unsupported streams.
            try:
                from .roi import decode_pixels_roi

                # ROI windows are small and variably shaped — the host pixel
                # stage wins: per-region shapes defeat jit caching and the
                # device round-trip (the same reasoning keeps nvjpeg's ROI on
                # its single-image, not batched, path).
                img = decode_pixels_roi(
                    frame, data, params.region, use_jax=False,
                    fancy=getattr(self, "fancy_upsampling", True),
                    bitexact=self.bitexact,
                )
            except Exception:
                img = None
        if img is None:
            coefs = _entropy_decode(frame, data)
            img = decode_pixels(frame, coefs, use_jax=self.use_jax,
                                bitexact=self.bitexact)
        if frame.precision > 8 and not params.allow_any_depth:
            # default u8 output (reference python default,
            # python/decoder.cpp:156-225; allow_any_depth keeps u16)
            img = (img >> (frame.precision - 8)).astype(
                np.uint8 if isinstance(img, np.ndarray) else "uint8"
            )
        if img.ndim == 3 and img.shape[-1] == 4:
            # CMYK/YCCK → RGB by default; UNCHANGED keeps native channels
            # (reference: color_spec routing, python/decoder.cpp:156-225)
            cs = getattr(params, "color_spec", None)
            if not (cs is not None and int(cs) == int(ColorSpec.UNCHANGED)):
                xp = np if isinstance(img, np.ndarray) else None
                if xp is None:
                    import jax.numpy as xp
                img = cmyk_to_rgb(img, xp)
        return img

    def decode_batch(self, data_batch, info_batch, params) -> List[DecodeResult]:
        out = []
        for data, info in zip(data_batch, info_batch):
            try:
                out.append(
                    DecodeResult(
                        ProcessingStatus.SUCCESS,
                        self._decode_one(bytes(data), params,
                                         roi_ok=_roi_ok(info, params)),
                    )
                )
            except Exception as e:
                out.append(
                    DecodeResult(
                        ProcessingStatus.FAIL | ProcessingStatus.IMAGE_CORRUPTED,
                        error=str(e),
                    )
                )
        return out


class JpegHybridTpuDecoder(_JpegDecoderBase):
    """Host or device entropy + device pixel stage (jitted per geometry)."""

    plugin_id = "tpu_jpeg_hybrid_decoder"
    backend_kind = BackendKind.HYBRID_CPU_TPU
    priority = Priority.HIGH
    use_jax = True
    fancy_upsampling = True
    mesh = None  # set by the scheduler for Decoder(mesh=...): DP sharding

    def set_options(self, opts) -> None:
        # reference knob: fancy_upsampling (include/nvimgcodec.h:1593-1594)
        from ...core.options import get_bool, get_int

        self.fancy_upsampling = get_bool(opts, "fancy_upsampling", True)
        self.bitexact = get_bool(opts, "bitexact", False)
        # allocator-policy knobs (reference analog: the custom pinned
        # allocator hooks, include/nvimgcodec.h:232-302)
        pool_mb = get_int(opts, "host_pool_mb", 0)
        pool_cap = get_int(opts, "host_pool_per_key_cap", 0)
        if pool_mb or pool_cap:
            from .batch import configure_host_pool

            configure_host_pool(max_mb=pool_mb or None,
                                per_key_cap=pool_cap or None)

    def decode_batch(self, data_batch, info_batch, params) -> List[DecodeResult]:
        if params.enable_roi and params.region is not None:
            # ROI decode is per-sample (windowed geometry defeats shape
            # bucketing); the entropy-skip path handles it.
            return _JpegDecoderBase.decode_batch(
                self, data_batch, info_batch, params
            )
        # Batched device path: entropy-decode all samples on host, then run the
        # pixel stage grouped by geometry in single jitted calls
        # (the XLA analog of the reference's batched nvjpegDecodeBatched).
        from .batch import decode_batch_device

        return decode_batch_device(data_batch, params,
                                fancy=self.fancy_upsampling, mesh=self.mesh,
                                bitexact=self.bitexact)


class JpegCpuDecoder(_JpegDecoderBase):
    plugin_id = "cpu_jpeg_decoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.NORMAL
    use_jax = False

    def set_options(self, opts) -> None:
        # bitexact=true: integer islow IDCT — decodes match libjpeg-turbo
        # byte-exactly (BASELINE configs[1] "bit-exact spec decode")
        from ...core.options import get_bool

        self.bitexact = get_bool(opts, "bitexact", False)


class JpegHybridTpuEncoder(EncoderPlugin):
    """Batched device encoder: bucketed device fDCT/quant + native host Huffman
    (the reference's HYBRID_CPU_GPU nvjpeg encoder ladder slot,
    extensions/nvjpeg/cuda_encoder.cpp:284-436). First in the priority
    chain; per-sample failures re-route to cpu_jpeg_encoder at runtime."""

    codec = "jpeg"
    plugin_id = "tpu_jpeg_hybrid_encoder"
    backend_kind = BackendKind.HYBRID_CPU_TPU
    priority = Priority.HIGH
    mesh = None  # set by the scheduler for Encoder(mesh=...)

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

    def encode_batch(self, image_batch, info_batch, params) -> List[EncodeResult]:
        from .batch_encode import encode_batch_device

        return encode_batch_device(image_batch, params, mesh=self.mesh)


class JpegCpuEncoder(EncoderPlugin):
    codec = "jpeg"
    plugin_id = "cpu_jpeg_encoder"
    backend_kind = BackendKind.CPU_ONLY
    priority = Priority.NORMAL
    device_pixel_stage = False  # opt-in: fDCT+quant on the accelerator

    def set_options(self, opts) -> None:
        # device_pixel_stage=true runs the fused color/downsample/fDCT/quant
        # stage under jax (worth it on real hardware; the quantizer boundary
        # may differ by one ulp on a handful of coefficients vs numpy)
        from ...core.options import get_bool

        self.device_pixel_stage = get_bool(opts, "device_pixel_stage", False)

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

    def encode_batch(self, image_batch, info_batch, params) -> List[EncodeResult]:
        # fan samples over a thread pool (numpy pixel stage + GIL-releasing
        # native entropy encode — the executor fan-out analog,
        # extensions/nvjpeg/cuda_encoder.cpp per-sample tasks)
        import os
        from concurrent.futures import ThreadPoolExecutor

        from .encode import encode_jpeg

        use_jax = False
        if self.device_pixel_stage:
            try:
                import jax

                use_jax = jax.default_backend() != "cpu"
            except Exception:
                use_jax = False

        def one(img):
            return encode_jpeg(np.asarray(img), params, use_jax=use_jax)

        if len(image_batch) > 1:
            with ThreadPoolExecutor(
                max_workers=min(len(image_batch), os.cpu_count() or 2)
            ) as pool:
                futs = [pool.submit(one, img) for img in image_batch]
                out = []
                for f in futs:
                    try:
                        out.append(EncodeResult(ProcessingStatus.SUCCESS, f.result()))
                    except Exception as e:
                        out.append(EncodeResult(ProcessingStatus.FAIL, error=str(e)))
                return out
        out = []
        for img in image_batch:
            try:
                out.append(EncodeResult(ProcessingStatus.SUCCESS, one(img)))
            except Exception as e:
                out.append(EncodeResult(ProcessingStatus.FAIL, error=str(e)))
        return out


def register(registry) -> None:
    codec = registry.codec("jpeg")
    codec.register_decoder(JpegHybridTpuDecoder())
    codec.register_decoder(JpegCpuDecoder())
    try:
        from .lossless import JpegLosslessDecoder

        codec.register_decoder(JpegLosslessDecoder())
    except ImportError:
        pass
    try:
        from .encode import encode_jpeg  # noqa: F401

        codec.register_encoder(JpegHybridTpuEncoder())
        codec.register_encoder(JpegCpuEncoder())
    except ImportError:
        pass
