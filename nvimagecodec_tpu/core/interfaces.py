"""Plugin interfaces: parser / decoder / encoder.

Counterpart of the reference's C vtable descriptors
(reference: include/nvimgcodec.h — Parser :1034-1082, Decoder :1150-1209,
Encoder :1087-1145). Instead of C structs of function pointers we use small
ABCs; the registry stores factories with priorities and the scheduler calls
`can_decode` batched, exactly like the reference
(src/image_decoder.cpp:55-80, extensions/*/... canDecode loops).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .image_info import ImageInfo
from .types import BackendKind, Priority, ProcessingStatus


@dataclasses.dataclass
class DecodeParams:
    """Decode options (reference: nvimgcodecDecodeParams_t,
    include/nvimgcodec.h:622-631 + python/decode_params.cpp)."""

    apply_exif_orientation: bool = True
    allow_any_depth: bool = False
    enable_roi: bool = False
    # Output color routing (reference: color_spec handling in
    # python/decoder.cpp:156-225): None/SRGB → RGB (the default),
    # GRAY → single-channel luma, UNCHANGED → the stream's native
    # channels (e.g. CMYK stays 4-channel).
    color_spec: Optional[object] = None  # core.types.ColorSpec
    # Region of interest applied when enable_roi is set (reference: ROI via
    # nvimgcodecImageInfo_t.region, include/nvimgcodec.h:487 + decode_params
    # enable_roi :629). End-exclusive pixel coordinates.
    region: Optional[object] = None  # core.types.Region
    # Output layout/channel-order (reference: nvimgcodecImageInfo_t
    # .sample_format drives the convert-kernel matrix,
    # src/imgproc/convert_kernel_gpu.cu:30-290): None → I_RGB behavior;
    # P_* formats emit planar CHW.
    sample_format: Optional[object] = None  # core.types.SampleFormat
    # Output dtype with saturating-normalized rescale (reference:
    # ConvertSatNorm, src/imgproc/convert.h): e.g. FLOAT32 → [0,1].
    sample_type: Optional[object] = None  # core.types.SampleDataType


@dataclasses.dataclass
class EncodeParams:
    """Encode options (reference: nvimgcodecEncodeParams_t,
    include/nvimgcodec.h:636-657 + python/encode_params.cpp)."""

    quality: float = 95.0
    target_psnr: float = 50.0
    chroma_subsampling: Optional[object] = None  # ChromaSubsampling
    color_spec: Optional[object] = None
    jpeg: Optional["JpegEncodeParams"] = None
    jpeg2k: Optional["Jpeg2kEncodeParams"] = None


@dataclasses.dataclass
class JpegEncodeParams:
    """(reference: nvimgcodecJpegEncodeParams_t, include/nvimgcodec.h:702-714)"""

    progressive: bool = False
    optimized_huffman: bool = False


@dataclasses.dataclass
class Jpeg2kEncodeParams:
    """(reference: nvimgcodecJpeg2kEncodeParams_t, include/nvimgcodec.h:685-697)"""

    reversible: bool = False
    code_block_w: int = 64
    code_block_h: int = 64
    num_resolutions: int = 6
    prog_order: str = "RPCL"
    stream_type: str = "jp2"  # or "j2k"
    # quality layers (each code-block's passes split across layers; reference:
    # num_layers in nvjpeg2k encode params)
    num_layers: int = 1
    # precinct partition exponents: None, one (PPx, PPy) pair, or a
    # per-resolution list (T.800 A-21)
    precincts: Optional[object] = None
    # HTJ2K (ITU-T T.814): use the HT block coder — the reference's
    # "High Throughput JPEG2000" (README.md:38, nvjpeg2k native)
    ht: bool = False
    # part-1 T1 mode switches (T.800 A.6.1 SPcod bits, ignored when ht):
    # 0x01 BYPASS, 0x02 RESET, 0x04 TERMALL, 0x08 CAUSAL, 0x20 SEGSYM
    mode_switches: int = 0


class ParserPlugin:
    """Format sniffer + header parser
    (reference: parser desc, include/nvimgcodec.h:1034-1082; impls in
    src/parsers/*.cpp)."""

    codec: str = ""
    priority: Priority = Priority.NORMAL

    def can_parse(self, data: memoryview) -> bool:
        raise NotImplementedError

    def parse(self, data: memoryview) -> ImageInfo:
        raise NotImplementedError


class DecoderPlugin:
    """Batched decoder backend
    (reference: decoder desc, include/nvimgcodec.h:1150-1209; plugin shape per
    extensions/* — canDecode filter then batch decode)."""

    codec: str = ""
    plugin_id: str = ""
    backend_kind: BackendKind = BackendKind.CPU_ONLY
    priority: Priority = Priority.NORMAL

    def set_options(self, opts) -> None:
        """Free-form per-plugin options (reference: "<plugin>:<k>=<v>"
        strings, e.g. extensions/nvjpeg/cuda_decoder.cpp:188-209)."""

    def can_decode(
        self,
        data_batch: Sequence[memoryview],
        info_batch: Sequence[ImageInfo],
        params: DecodeParams,
    ) -> List[ProcessingStatus]:
        """Per-sample feasibility check; SUCCESS bit set if this backend can
        handle the sample (reference: extensions/nvjpeg/cuda_decoder.cpp:124-174)."""
        raise NotImplementedError

    def decode_batch(
        self,
        data_batch: Sequence[memoryview],
        info_batch: Sequence[ImageInfo],
        params: DecodeParams,
    ) -> List["DecodeResult"]:
        raise NotImplementedError


class EncoderPlugin:
    """Batched encoder backend
    (reference: encoder desc, include/nvimgcodec.h:1087-1145)."""

    codec: str = ""
    plugin_id: str = ""
    backend_kind: BackendKind = BackendKind.CPU_ONLY
    priority: Priority = Priority.NORMAL

    def set_options(self, opts) -> None:
        """Free-form per-plugin options (see DecoderPlugin.set_options)."""

    def can_encode(
        self,
        image_batch: Sequence[np.ndarray],
        info_batch: Sequence[ImageInfo],
        params: EncodeParams,
    ) -> List[ProcessingStatus]:
        raise NotImplementedError

    def encode_batch(
        self,
        image_batch: Sequence[np.ndarray],
        info_batch: Sequence[ImageInfo],
        params: EncodeParams,
    ) -> List["EncodeResult"]:
        raise NotImplementedError


@dataclasses.dataclass
class DecodeResult:
    """Per-sample decode outcome; `array` is numpy (host path) or jax.Array
    (device path) in interleaved HWC layout unless planar was requested."""

    status: ProcessingStatus
    array: Optional[object] = None
    error: Optional[str] = None


@dataclasses.dataclass
class EncodeResult:
    status: ProcessingStatus
    data: Optional[bytes] = None
    error: Optional[str] = None
