"""CodeStream: encoded bytes + lazily-selected parser + cached ImageInfo.

Counterpart of the reference CodeStream
(reference: src/code_stream.cpp:28-127 — wraps an IoStream, resolves a parser
via the registry on first use, caches the parsed nvimgcodecImageInfo_t).
"""
from __future__ import annotations

from typing import Optional, Union

from .image_info import ImageInfo
from .io_stream import IoStream, as_iostream
from .registry import CodecRegistry, global_registry


class CodeStreamError(RuntimeError):
    pass


class CodeStream:
    """Parse-on-demand view of one encoded image."""

    def __init__(self, src, registry: Optional[CodecRegistry] = None):
        self._io: IoStream = as_iostream(src)
        self._registry = registry or global_registry()
        self._parser = None
        self._info: Optional[ImageInfo] = None

    @property
    def data(self) -> memoryview:
        return self._io.view()

    @property
    def codec_name(self) -> str:
        self._ensure_parser()
        return self._parser.codec  # type: ignore[union-attr]

    def _ensure_parser(self) -> None:
        if self._parser is None:
            parser = self._registry.find_parser(self.data)
            if parser is None:
                raise CodeStreamError("could not match any known image format")
            self._parser = parser

    def get_image_info(self) -> ImageInfo:
        """Parse and cache (reference: src/code_stream.cpp:75-98)."""
        if self._info is None:
            self._ensure_parser()
            self._info = self._parser.parse(self.data)  # type: ignore[union-attr]
        return self._info
