"""WebP header parser.

Counterpart of src/parsers/webp.cpp (378 LoC): RIFF/WEBP container,
VP8 (lossy) / VP8L (lossless) / VP8X (extended, alpha flag) dimensions, EXIF
chunk orientation.
"""
from __future__ import annotations

import struct

from ..core.image_info import ImageInfo, make_planes
from ..core.interfaces import ParserPlugin
from ..core.types import (
    ChromaSubsampling,
    ColorSpec,
    Orientation,
    Priority,
    SampleDataType,
    SampleFormat,
)
from .exif import parse_exif_orientation


class WebpParser(ParserPlugin):
    codec = "webp"
    priority = Priority.NORMAL

    def can_parse(self, data: memoryview) -> bool:
        return (
            len(data) >= 12
            and bytes(data[:4]) == b"RIFF"
            and bytes(data[8:12]) == b"WEBP"
        )

    def parse(self, data: memoryview) -> ImageInfo:
        raw = bytes(data)
        pos = 12
        w = h = 0
        nch = 3
        lossless = False
        orientation = Orientation.NORMAL
        has_alpha = False
        variant = ""

        while pos + 8 <= len(raw):
            fourcc = raw[pos : pos + 4]
            (size,) = struct.unpack_from("<I", raw, pos + 4)
            body = raw[pos + 8 : pos + 8 + size]
            if fourcc == b"VP8 " and len(body) >= 10:
                variant = "vp8"
                # Lossy: frame tag (3B) + start code 9D 01 2A + 14-bit w/h
                if body[3:6] == b"\x9d\x01\x2a":
                    w = struct.unpack_from("<H", body, 6)[0] & 0x3FFF
                    h = struct.unpack_from("<H", body, 8)[0] & 0x3FFF
            elif fourcc == b"VP8L" and len(body) >= 5:
                variant = "vp8l"
                lossless = True
                if body[0] == 0x2F:
                    bits = struct.unpack_from("<I", body, 1)[0]
                    w = (bits & 0x3FFF) + 1
                    h = ((bits >> 14) & 0x3FFF) + 1
                    has_alpha = bool((bits >> 28) & 1)
            elif fourcc == b"VP8X" and len(body) >= 10:
                flags = body[0]
                has_alpha = bool(flags & 0x10)
                w = 1 + (body[4] | body[5] << 8 | body[6] << 16)
                h = 1 + (body[7] | body[8] << 8 | body[9] << 16)
            elif fourcc == b"ALPH":
                has_alpha = True
            elif fourcc == b"EXIF":
                o = parse_exif_orientation(memoryview(body))
                if o is not None:
                    orientation = o
            pos += 8 + size + (size & 1)  # chunks are 2-byte aligned

        if w == 0 or h == 0:
            raise ValueError("WebP: no dimensions found")
        nch = 4 if has_alpha else 3
        return ImageInfo(
            codec=self.codec,
            height=h,
            width=w,
            num_planes=nch,
            planes=make_planes(h, w, nch, SampleDataType.UINT8),
            sample_format=SampleFormat.I_RGB,
            color_spec=ColorSpec.SRGB,
            chroma_subsampling=(
                ChromaSubsampling.NONE if lossless else ChromaSubsampling.CSS_420
            ),
            orientation=orientation,
            extras={"webp_variant": variant, "webp_lossless": lossless},
        )
