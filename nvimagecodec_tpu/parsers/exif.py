"""Minimal EXIF (TIFF-tag) reader for orientation extraction.

Counterpart of the reference's shared EXIF reader
(reference: src/parsers/exif.cpp (538 LoC), orientation mapping in
src/parsers/exif_orientation.h). We only need tag 0x0112 (orientation), read
from a TIFF-structured blob that may be embedded in JPEG APP1 / WebP EXIF /
PNG eXIf chunks.
"""
from __future__ import annotations

import struct
from typing import Optional

from ..core.types import Orientation

ORIENTATION_TAG = 0x0112


def parse_exif_orientation(data: memoryview) -> Optional[Orientation]:
    """Parse a TIFF-structured EXIF blob and return orientation, or None."""
    b = bytes(data[:8])
    if len(b) < 8:
        return None
    if b[:2] == b"II":
        endian = "<"
    elif b[:2] == b"MM":
        endian = ">"
    else:
        return None
    (magic,) = struct.unpack_from(endian + "H", b, 2)
    if magic != 42:
        return None
    (ifd_offset,) = struct.unpack_from(endian + "I", b, 4)
    raw = bytes(data)
    # Walk IFD0 entries only; orientation lives in IFD0.
    try:
        if ifd_offset + 2 > len(raw):
            return None
        (count,) = struct.unpack_from(endian + "H", raw, ifd_offset)
        pos = ifd_offset + 2
        for _ in range(count):
            if pos + 12 > len(raw):
                return None
            tag, typ, n = struct.unpack_from(endian + "HHI", raw, pos)
            if tag == ORIENTATION_TAG and typ == 3 and n >= 1:  # SHORT
                (val,) = struct.unpack_from(endian + "H", raw, pos + 8)
                if 1 <= val <= 8:
                    return Orientation(val)
                return None
            pos += 12
    except struct.error:
        return None
    return None
