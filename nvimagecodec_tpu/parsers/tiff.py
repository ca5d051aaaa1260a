"""TIFF header parser.

Counterpart of src/parsers/tiff.cpp (375 LoC): II*/MM* magic, IFD
entry walk extracting width/height/samples-per-pixel/bits-per-sample/
photometric (palette → 3 channels)/orientation, templated over LE/BE.
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

TAG_WIDTH = 256
TAG_HEIGHT = 257
TAG_BITS_PER_SAMPLE = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_SAMPLES_PER_PIXEL = 277
TAG_ORIENTATION = 274

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}


def read_ifd_tags(raw: bytes, endian: str, ifd_offset: int) -> dict:
    """Return {tag: [values]} for the IFD at `ifd_offset`."""
    tags = {}
    (count,) = struct.unpack_from(endian + "H", raw, ifd_offset)
    pos = ifd_offset + 2
    fmt_for = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d"}
    for _ in range(count):
        tag, typ, n = struct.unpack_from(endian + "HHI", raw, pos)
        f = fmt_for.get(typ)
        if f is not None:
            size = _TYPE_SIZE[typ] * n
            off = pos + 8 if size <= 4 else struct.unpack_from(endian + "I", raw, pos + 8)[0]
            try:
                vals = list(struct.unpack_from(endian + str(n) + f, raw, off))
            except struct.error:
                vals = []
            tags[tag] = vals
        pos += 12
    return tags


class TiffParser(ParserPlugin):
    codec = "tiff"
    priority = Priority.NORMAL

    def can_parse(self, data: memoryview) -> bool:
        if len(data) < 8:
            return False
        b = bytes(data[:4])
        return b in (b"II*\x00", b"MM\x00*")

    def parse(self, data: memoryview) -> ImageInfo:
        raw = bytes(data)
        endian = "<" if raw[:2] == b"II" else ">"
        (ifd_offset,) = struct.unpack_from(endian + "I", raw, 4)
        tags = read_ifd_tags(raw, endian, ifd_offset)

        w = tags.get(TAG_WIDTH, [0])[0]
        h = tags.get(TAG_HEIGHT, [0])[0]
        bps = tags.get(TAG_BITS_PER_SAMPLE, [8])
        spp = tags.get(TAG_SAMPLES_PER_PIXEL, [len(bps) if bps else 1])[0]
        photometric = tags.get(TAG_PHOTOMETRIC, [1])[0]
        orient_val = tags.get(TAG_ORIENTATION, [1])[0]

        nch = spp
        if photometric == 3:  # palette expands to RGB (reference: tiff.cpp)
            nch = 3
        bitdepth = bps[0] if bps else 8
        sample_fmt = tags.get(339, [1])[0]  # SampleFormat: 3 = IEEE float
        if sample_fmt == 3 and bitdepth == 32:
            st = SampleDataType.FLOAT32
        elif sample_fmt == 3 and bitdepth == 64:
            st = SampleDataType.FLOAT64
        elif bitdepth <= 8:
            st = SampleDataType.UINT8
        elif bitdepth <= 16:
            st = SampleDataType.UINT16
        else:
            st = SampleDataType.UINT32
        precision = bitdepth if bitdepth not in (8, 16, 32) else 0

        gray = nch == 1
        orientation = (
            Orientation(orient_val) if 1 <= orient_val <= 8 else Orientation.NORMAL
        )
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
                "tiff_photometric": photometric,
                "tiff_compression": tags.get(TAG_COMPRESSION, [1])[0],
                "tiff_bits_per_sample": bps,
            },
        )
