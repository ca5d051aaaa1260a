"""Core enums and small value types.

Re-design of the reference's public enum surface
(reference: include/nvimgcodec.h:307-670 — status codes, sample types, chroma
subsampling, sample formats, color specs, JPEG encodings, backend kinds,
processing-status bitmask, J2K progression orders). Values are semantically
equivalent but the numeric encoding is our own.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


class Status(enum.IntEnum):
    """API-level status (reference: include/nvimgcodec.h:307-332)."""

    SUCCESS = 0
    NOT_INITIALIZED = 1
    INVALID_PARAMETER = 2
    BAD_CODESTREAM = 3
    CODESTREAM_UNSUPPORTED = 4
    ALLOCATOR_FAILURE = 5
    EXECUTION_FAILED = 6
    INTERNAL_ERROR = 7
    IMPLEMENTATION_UNSUPPORTED = 8
    MISSED_DEPENDENCIES = 9
    EXTENSION_NOT_FOUND = 10


class ProcessingStatus(enum.IntFlag):
    """Per-sample processing status bitmask
    (reference: include/nvimgcodec.h:583-612).

    SUCCESS/FAIL are mutually exclusive bits; the remaining bits qualify *why*
    a sample failed or was only partially processed, so a fallback backend can
    be tried (reference: src/decoder_worker.cpp:158-199).
    """

    UNKNOWN = 0
    SUCCESS = 1
    FAIL = 2
    IMAGE_CORRUPTED = 4
    CODEC_UNSUPPORTED = 8
    BACKEND_UNSUPPORTED = 16
    ENCODING_UNSUPPORTED = 32
    RESOLUTION_UNSUPPORTED = 64
    CODESTREAM_UNSUPPORTED = 128
    SAMPLING_UNSUPPORTED = 256
    SAMPLE_TYPE_UNSUPPORTED = 512
    SAMPLE_FORMAT_UNSUPPORTED = 1024
    NUM_CHANNELS_UNSUPPORTED = 2048
    NUM_PLANES_UNSUPPORTED = 4096
    COLOR_SPEC_UNSUPPORTED = 8192
    ORIENTATION_UNSUPPORTED = 16384
    ROI_UNSUPPORTED = 32768
    SATURATED = 65536  # backend at capacity; retry on fallback (nvimgcodec.h:596)


class SampleDataType(enum.IntEnum):
    """Pixel sample dtypes (reference: include/nvimgcodec.h:343-359)."""

    UNKNOWN = 0
    INT8 = 1
    UINT8 = 2
    INT16 = 3
    UINT16 = 4
    INT32 = 5
    UINT32 = 6
    INT64 = 7
    UINT64 = 8
    FLOAT16 = 9
    FLOAT32 = 10
    FLOAT64 = 11

    @property
    def numpy_dtype(self):
        import numpy as np

        return {
            SampleDataType.INT8: np.int8,
            SampleDataType.UINT8: np.uint8,
            SampleDataType.INT16: np.int16,
            SampleDataType.UINT16: np.uint16,
            SampleDataType.INT32: np.int32,
            SampleDataType.UINT32: np.uint32,
            SampleDataType.INT64: np.int64,
            SampleDataType.UINT64: np.uint64,
            SampleDataType.FLOAT16: np.float16,
            SampleDataType.FLOAT32: np.float32,
            SampleDataType.FLOAT64: np.float64,
        }[self]

    @staticmethod
    def from_numpy(dtype) -> "SampleDataType":
        import numpy as np

        m = {
            np.dtype(np.int8): SampleDataType.INT8,
            np.dtype(np.uint8): SampleDataType.UINT8,
            np.dtype(np.int16): SampleDataType.INT16,
            np.dtype(np.uint16): SampleDataType.UINT16,
            np.dtype(np.int32): SampleDataType.INT32,
            np.dtype(np.uint32): SampleDataType.UINT32,
            np.dtype(np.int64): SampleDataType.INT64,
            np.dtype(np.uint64): SampleDataType.UINT64,
            np.dtype(np.float16): SampleDataType.FLOAT16,
            np.dtype(np.float32): SampleDataType.FLOAT32,
            np.dtype(np.float64): SampleDataType.FLOAT64,
        }
        return m[np.dtype(dtype)]

    @property
    def itemsize(self) -> int:
        import numpy as np

        return np.dtype(self.numpy_dtype).itemsize


class ChromaSubsampling(enum.IntEnum):
    """Chroma subsampling (reference: include/nvimgcodec.h:364-377)."""

    NONE = 0  # 4:4:4
    CSS_444 = 0
    CSS_422 = 1
    CSS_420 = 2
    CSS_440 = 3
    CSS_411 = 4
    CSS_410 = 5
    GRAY = 6
    CSS_410V = 7
    UNSUPPORTED = 8


class SampleFormat(enum.IntEnum):
    """Sample format: P_* = planar, I_* = interleaved
    (reference: include/nvimgcodec.h:382-395)."""

    UNKNOWN = 0
    P_UNCHANGED = 1
    I_UNCHANGED = 2
    P_RGB = 3
    I_RGB = 4
    P_BGR = 5
    I_BGR = 6
    P_Y = 7
    P_YUV = 9


class ColorSpec(enum.IntEnum):
    """Color specification (reference: include/nvimgcodec.h:400-411)."""

    UNSUPPORTED = -1
    UNKNOWN = 0
    UNCHANGED = 0
    SRGB = 1
    GRAY = 2
    SYCC = 3
    CMYK = 4
    YCCK = 5


class JpegEncoding(enum.IntEnum):
    """JPEG entropy/scan arrangement, values match the SOF marker low byte
    (reference: include/nvimgcodec.h:506-524)."""

    UNKNOWN = 0
    BASELINE_DCT = 0xC0
    EXTENDED_SEQUENTIAL_DCT_HUFFMAN = 0xC1
    PROGRESSIVE_DCT_HUFFMAN = 0xC2
    LOSSLESS_HUFFMAN = 0xC3
    DIFFERENTIAL_SEQUENTIAL_DCT_HUFFMAN = 0xC5
    DIFFERENTIAL_PROGRESSIVE_DCT_HUFFMAN = 0xC6
    DIFFERENTIAL_LOSSLESS_HUFFMAN = 0xC7
    RESERVED_FOR_JPEG_EXTENSIONS = 0xC8
    EXTENDED_SEQUENTIAL_DCT_ARITHMETIC = 0xC9
    PROGRESSIVE_DCT_ARITHMETIC = 0xCA
    LOSSLESS_ARITHMETIC = 0xCB
    DIFFERENTIAL_SEQUENTIAL_DCT_ARITHMETIC = 0xCD
    DIFFERENTIAL_PROGRESSIVE_DCT_ARITHMETIC = 0xCE
    DIFFERENTIAL_LOSSLESS_ARITHMETIC = 0xCF


class Orientation(enum.IntEnum):
    """EXIF orientation (reference: src/parsers/exif_orientation.h).

    Value semantics follow the EXIF spec tag 0x0112.
    """

    NORMAL = 1
    MIRROR_HORIZONTAL = 2
    ROTATE_180 = 3
    MIRROR_VERTICAL = 4
    MIRROR_HORIZONTAL_ROTATE_270_CW = 5
    ROTATE_90_CW = 6
    MIRROR_HORIZONTAL_ROTATE_90_CW = 7
    ROTATE_270_CW = 8

    @property
    def swaps_xy(self) -> bool:
        return self in (
            Orientation.MIRROR_HORIZONTAL_ROTATE_270_CW,
            Orientation.ROTATE_90_CW,
            Orientation.MIRROR_HORIZONTAL_ROTATE_90_CW,
            Orientation.ROTATE_270_CW,
        )


class BackendKind(enum.IntEnum):
    """Where a codec backend runs (reference: include/nvimgcodec.h:543-549).

    The reference ladder is HW_GPU_ONLY → GPU_ONLY → HYBRID_CPU_GPU → CPU_ONLY;
    ours is TPU_ONLY → HYBRID_CPU_TPU → CPU_ONLY.
    """

    CPU_ONLY = 1
    TPU_ONLY = 2  # all pixel work on the device
    HYBRID_CPU_TPU = 3  # host entropy stage + TPU pixel stage
    HW_ONLY = 4  # reserved for dedicated offload engines


class Priority(enum.IntEnum):
    """Plugin registration priority; lower value = probed first
    (reference: plugin priorities, e.g. extensions/nvjpeg/nvjpeg_ext.cpp:44)."""

    VERY_HIGH = 100
    HIGH = 200
    NORMAL = 300
    LOW = 400
    VERY_LOW = 500


@dataclass(frozen=True)
class Region:
    """Decode region-of-interest, end-exclusive
    (reference: nvimgcodecRegion_t, include/nvimgcodec.h)."""

    start_y: int
    start_x: int
    end_y: int
    end_x: int

    @property
    def height(self) -> int:
        return self.end_y - self.start_y

    @property
    def width(self) -> int:
        return self.end_x - self.start_x


@dataclass(frozen=True)
class Backend:
    """Backend allowlist entry with a load fraction hint
    (reference: nvimgcodecBackend_t + load_hint, include/nvimgcodec.h:554-578)."""

    kind: BackendKind
    load_hint: float = 1.0


# Per-codec-name canonical strings (reference: codec names used by
# src/codec_registry.cpp and parsers; "jpeg" probed first, :39-43).
KNOWN_CODECS = ("jpeg", "jpeg2k", "png", "tiff", "bmp", "pnm", "webp")
