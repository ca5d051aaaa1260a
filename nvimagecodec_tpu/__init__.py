"""tpu-imagecodec: a batched image encode/decode engine for accelerators.

From-scratch re-design of the capabilities of nvImageCodec
(reference: /root/reference, v0.2.0-beta — see SURVEY.md) for JAX/XLA/Pallas:
unified decode/encode API with format auto-detection, priority-ordered codec
backends with per-sample fallback, batched variable-shape processing, and the
codec pixel stages (IDCT/DCT, DWT, color conversion, resampling) and JPEG
entropy decode running on the device (an NVIDIA GPU).
"""
from .version import __version__  # noqa: F401

from .core.types import (  # noqa: F401
    Backend,
    BackendKind,
    ChromaSubsampling,
    ColorSpec,
    JpegEncoding,
    Orientation,
    Priority,
    ProcessingStatus,
    Region,
    SampleDataType,
    SampleFormat,
    Status,
)
from .core.image_info import ImageInfo, PlaneInfo  # noqa: F401
from .core.interfaces import (  # noqa: F401
    DecodeParams,
    EncodeParams,
    Jpeg2kEncodeParams,
    JpegEncodeParams,
)
from .core.code_stream import CodeStream  # noqa: F401
from .core.logger import (  # noqa: F401
    DebugMessageCategory,
    DebugMessageData,
    DebugMessageSeverity,
    register_debug_messenger,
    unregister_debug_messenger,
)
from .core.thread_pool import PriorityThreadPool  # noqa: F401
from .core.registry import CodecRegistry, global_registry  # noqa: F401
from .api import Decoder, Encoder  # noqa: F401
from .codecs.webp_anim import (  # noqa: F401
    decode_webp_animation,
    encode_webp_animation,
)
from .image import Image, as_image, as_images, from_dlpack  # noqa: F401
from .codecs.jpeg.batch import configure_host_pool  # noqa: F401

__all__ = [
    "configure_host_pool",
    "__version__",
    "decode_webp_animation",
    "encode_webp_animation",
    "Backend",
    "BackendKind",
    "ChromaSubsampling",
    "CodecRegistry",
    "CodeStream",
    "ColorSpec",
    "DebugMessageCategory",
    "DebugMessageData",
    "DebugMessageSeverity",
    "DecodeParams",
    "Decoder",
    "EncodeParams",
    "Encoder",
    "PriorityThreadPool",
    "register_debug_messenger",
    "unregister_debug_messenger",
    "Image",
    "ImageInfo",
    "Jpeg2kEncodeParams",
    "JpegEncodeParams",
    "JpegEncoding",
    "Orientation",
    "PlaneInfo",
    "Priority",
    "ProcessingStatus",
    "Region",
    "SampleDataType",
    "SampleFormat",
    "Status",
    "as_image",
    "as_images",
    "from_dlpack",
    "global_registry",
]
