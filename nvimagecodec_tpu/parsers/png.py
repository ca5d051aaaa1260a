"""PNG header parser.

Counterpart of src/parsers/png.cpp (410 LoC): 8-byte signature,
IHDR dims/bitdepth/color-type → channels, eXIf chunk orientation.
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

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# color type → base channel count
_CHANNELS = {0: 1, 2: 3, 3: 3, 4: 2, 6: 4}


class PngParser(ParserPlugin):
    codec = "png"
    priority = Priority.NORMAL

    def can_parse(self, data: memoryview) -> bool:
        return len(data) >= 8 and bytes(data[:8]) == SIGNATURE

    def parse(self, data: memoryview) -> ImageInfo:
        raw = bytes(data)
        if raw[12:16] != b"IHDR":
            raise ValueError("PNG: first chunk is not IHDR")
        w, h, bitdepth, color_type, _comp, _filt, interlace = struct.unpack_from(
            ">IIBBBBB", raw, 16
        )
        nch = _CHANNELS.get(color_type)
        if nch is None:
            raise ValueError(f"PNG: bad color type {color_type}")

        orientation = Orientation.NORMAL
        # Chunk walk for eXIf (reference: png.cpp eXIf handling).
        pos = 8
        while pos + 8 <= len(raw):
            (length,) = struct.unpack_from(">I", raw, pos)
            ctype = raw[pos + 4 : pos + 8]
            if ctype == b"eXIf":
                o = parse_exif_orientation(memoryview(raw)[pos + 8 : pos + 8 + length])
                if o is not None:
                    orientation = o
                break
            if ctype in (b"IDAT", b"IEND"):
                break
            pos += 12 + length

        st = SampleDataType.UINT16 if bitdepth == 16 else SampleDataType.UINT8
        precision = bitdepth if bitdepth not in (8, 16) else 0
        gray = nch == 1
        return ImageInfo(
            codec=self.codec,
            height=h,
            width=w,
            num_planes=nch,
            planes=make_planes(h, w, nch, st, precision),
            sample_format=SampleFormat.P_Y if gray else SampleFormat.I_RGB,
            color_spec=ColorSpec.GRAY if gray else ColorSpec.SRGB,
            chroma_subsampling=ChromaSubsampling.GRAY if gray else ChromaSubsampling.NONE,
            orientation=orientation,
            extras={
                "png_bitdepth": bitdepth,
                "png_color_type": color_type,
                "png_interlace": interlace,
            },
        )
