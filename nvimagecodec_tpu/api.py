"""Public Decoder/Encoder API.

Counterpart of the reference Python binding surface
(reference: python/decoder.cpp:147-401 — decode/read for bytes/path/lists,
default u8 I_RGB output, allow_any_depth, EXIF handling, failed samples
dropped; python/encoder.cpp:110-290 — encode/write with quality/psnr and
codec-specific params).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import numpy as np

from .core.code_stream import CodeStream
from .core.interfaces import DecodeParams, EncodeParams
from .core.registry import CodecRegistry, global_registry
from .core.scheduler import GenericDecoder, GenericEncoder
from .core.types import Backend, ColorSpec, ProcessingStatus
from .image import Image, apply_exif_orientation, as_image

Source = Union[bytes, bytearray, memoryview, str, os.PathLike, CodeStream]

_EXT_TO_CODEC = {
    ".bmp": "bmp",
    ".ppm": "pnm",
    ".pgm": "pnm",
    ".pbm": "pnm",
    ".pnm": "pnm",
    ".jpg": "jpeg",
    ".jpeg": "jpeg",
    ".jp2": "jpeg2k",
    ".j2k": "jpeg2k",
    "jp2": "jpeg2k",
    "j2k": "jpeg2k",
    "jpeg2000": "jpeg2k",
    "jpg": "jpeg",
    "png": "png",
    ".png": "png",
    ".tif": "tiff",
    "tif": "tiff",
    ".tiff": "tiff",
    ".webp": "webp",
    "webp": "webp",
}


class Decoder:
    """Batched image decoder (reference: python/decoder.cpp)."""

    def __init__(
        self,
        backends: Optional[Sequence[Backend]] = None,
        options: str = "",
        max_num_cpu_threads: int = 0,
        registry: Optional[CodecRegistry] = None,
        executor=None,
        mesh=None,
    ):
        """`mesh`: optional jax.sharding.Mesh. Device decode stages shard
        over it — image batches over the "dp" axis, J2K tiles/DWT rows over
        "sp" — replacing the single-device dispatch (SURVEY.md §2.7)."""
        self._generic = GenericDecoder(
            registry=registry,
            backends=backends,
            options=options,
            max_num_cpu_threads=max_num_cpu_threads,
            executor=executor,
            mesh=mesh,
        )

    # -- single/batch entry points (reference: decoder.cpp:147-253) ---------
    def decode(self, src, params: Optional[DecodeParams] = None, **kw):
        if isinstance(src, (list, tuple)):
            return self._decode_batch(list(src), params, **kw)
        return self._decode_batch([src], params, **kw)[0]

    def read(self, path, params: Optional[DecodeParams] = None, **kw):
        """Decode from file path(s) (reference: Decoder.read)."""
        return self.decode(path, params, **kw)

    def decode_async(self, sources, params: Optional[DecodeParams] = None):
        """Submit a batch and return a ProcessingResultsFuture: `wait_all()`
        for every result, `wait_new()` for incremental per-sample completion
        (reference: nvimgcodecFuture + ProcessingResultsFuture::wait_new,
        src/processing_results.cpp:78-93). Results are raw DecodeResults;
        use `decode` for the Image-wrapping convenience path."""
        params = params or DecodeParams()
        srcs = sources if isinstance(sources, (list, tuple)) else [sources]
        streams = [
            s if isinstance(s, CodeStream) else CodeStream(s, self._generic.registry)
            for s in srcs
        ]
        return self._generic.decode_batch_async(streams, params)

    def _decode_batch(self, sources: List[Source], params, to_device: bool = False):
        params = params or DecodeParams()
        streams = [
            s if isinstance(s, CodeStream) else CodeStream(s, self._generic.registry)
            for s in sources
        ]
        results = self._generic.decode_batch(streams, params)
        out: List[Optional[Image]] = []
        for cs, r in zip(streams, results):
            if not (r.status & ProcessingStatus.SUCCESS) or r.array is None:
                # Failed samples are returned as None
                # (reference: failed samples dropped, python/decoder.cpp:228-246).
                out.append(None)
                continue
            arr = r.array
            info = cs.get_image_info()
            if params.apply_exif_orientation:
                arr = apply_exif_orientation(arr, info.orientation)
                if isinstance(arr, np.ndarray):
                    arr = np.ascontiguousarray(arr)
            if params.enable_roi and params.region is not None:
                rg = params.region
                # Codecs with true ROI decode (JPEG entropy-skip, J2K tile
                # subset) already return the region; crop only as the
                # fallback for codecs without it.
                if not (arr.shape[0] == rg.height and arr.shape[1] == rg.width):
                    arr = arr[rg.start_y : rg.end_y, rg.start_x : rg.end_x]
                    if isinstance(arr, np.ndarray):
                        arr = np.ascontiguousarray(arr)
            if (
                params.color_spec is not None
                and int(params.color_spec) == int(ColorSpec.GRAY)
                and arr.ndim == 3
                and arr.shape[-1] >= 3
            ):
                # BT.601 luma, fixed-point (reference GRAY routing)
                xp = np if isinstance(arr, np.ndarray) else None
                if xp is None:
                    import jax.numpy as xp
                r32 = arr[..., 0].astype(xp.int32)
                g32 = arr[..., 1].astype(xp.int32)
                b32 = arr[..., 2].astype(xp.int32)
                y = (19595 * r32 + 38470 * g32 + 7471 * b32 + 32768) >> 16
                arr = y.astype(arr.dtype)
            if params.sample_format is not None or params.sample_type is not None:
                # Layout/dtype conversion matrix (reference: output image-info
                # sample_format/sample_type drive convert_kernel_gpu.cu:30-290)
                from .ops.convert import convert

                arr = convert(arr, params.sample_format, params.sample_type)
            img = Image(arr, info)
            if to_device:
                img = img.tpu()
            out.append(img)
        return out


class Encoder:
    """Batched image encoder (reference: python/encoder.cpp)."""

    def __init__(
        self,
        backends: Optional[Sequence[Backend]] = None,
        options: str = "",
        max_num_cpu_threads: int = 0,
        registry: Optional[CodecRegistry] = None,
        executor=None,
    ):
        self._generic = GenericEncoder(
            registry=registry,
            backends=backends,
            options=options,
            max_num_cpu_threads=max_num_cpu_threads,
            executor=executor,
        )

    def encode(
        self,
        images,
        codec: str,
        params: Optional[EncodeParams] = None,
    ):
        """Encode image(s) to bytes (reference: encoder.cpp:110-290)."""
        single = not isinstance(images, (list, tuple))
        imgs = [images] if single else list(images)
        codec = _EXT_TO_CODEC.get(codec.lower(), codec.lower())
        arrays, infos = [], []
        for im in imgs:
            im = as_image(im)
            arrays.append(np.asarray(im.cpu().array))
            infos.append(im.info)
        results = self._generic.encode_batch(arrays, infos, codec, params)
        data = [r.data if (r.status & ProcessingStatus.SUCCESS) else None for r in results]
        return data[0] if single else data

    def write(self, path, image, codec: str = "", params: Optional[EncodeParams] = None):
        """Encode to file; codec from extension unless given
        (reference: Encoder.write)."""
        if not codec:
            ext = os.path.splitext(os.fspath(path))[1].lower()
            codec = _EXT_TO_CODEC.get(ext, "")
            if not codec:
                raise ValueError(f"cannot infer codec from path {path!r}")
        data = self.encode(image, codec, params)
        if data is None:
            raise RuntimeError(f"encoding to {codec} failed")
        with open(path, "wb") as f:
            f.write(data)
        return path
