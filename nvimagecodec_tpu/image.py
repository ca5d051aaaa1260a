"""Image: decoded pixels with host/device migration and zero-copy interop.

Counterpart of the reference Python Image
(reference: python/image.cpp:433-480 — exports __array_interface__,
__cuda_array_interface__, __dlpack__, and .cpu()/.cuda() migration). Here the
device side is a jax.Array; `.cpu()` gives a numpy view and `__dlpack__`
hands the buffer to any DLPack consumer (torch, etc.) without copying where
the backing store allows it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .core.image_info import ImageInfo
from .core.types import Orientation


def apply_exif_orientation(arr, orientation: Orientation):
    """Undo EXIF orientation so the returned pixels are upright
    (reference: EXIF orientation handling in python/decoder.cpp:156-225 and
    src/parsers/exif_orientation.h)."""
    import numpy as _np

    xp = _np if isinstance(arr, _np.ndarray) else None
    if xp is None:
        import jax.numpy as xp  # type: ignore[no-redef]
    o = Orientation(orientation)
    if o == Orientation.NORMAL:
        return arr
    if o == Orientation.MIRROR_HORIZONTAL:
        return xp.flip(arr, axis=1)
    if o == Orientation.ROTATE_180:
        return xp.flip(xp.flip(arr, axis=0), axis=1)
    if o == Orientation.MIRROR_VERTICAL:
        return xp.flip(arr, axis=0)
    if o == Orientation.MIRROR_HORIZONTAL_ROTATE_270_CW:
        return xp.swapaxes(arr, 0, 1)
    if o == Orientation.ROTATE_90_CW:
        # stored image must be rotated 90° CW to display upright
        return xp.flip(xp.swapaxes(arr, 0, 1), axis=1)
    if o == Orientation.MIRROR_HORIZONTAL_ROTATE_90_CW:
        return xp.flip(xp.flip(xp.swapaxes(arr, 0, 1), axis=0), axis=1)
    if o == Orientation.ROTATE_270_CW:
        return xp.flip(xp.swapaxes(arr, 0, 1), axis=0)
    return arr


class Image:
    """Decoded image handle. Backing array is numpy (host) or jax.Array (device)."""

    def __init__(self, array, info: Optional[ImageInfo] = None):
        self._array = array
        self.info = info

    # -- basic properties ---------------------------------------------------
    @property
    def shape(self):
        return tuple(self._array.shape)

    @property
    def dtype(self):
        return np.dtype(str(self._array.dtype))

    @property
    def ndim(self) -> int:
        return self._array.ndim

    @property
    def height(self) -> int:
        return self._array.shape[0]

    @property
    def width(self) -> int:
        return self._array.shape[1]

    @property
    def buffer_kind(self) -> str:
        """'strided_host' or 'strided_device' (reference:
        nvimgcodecImageBufferKind_t)."""
        return "strided_host" if isinstance(self._array, np.ndarray) else "strided_device"

    # -- migration (reference: python/image.cpp .cpu()/.cuda()) -------------
    def cpu(self) -> "Image":
        if isinstance(self._array, np.ndarray):
            return self
        return Image(np.asarray(self._array), self.info)

    def tpu(self, device=None) -> "Image":
        import jax

        if not isinstance(self._array, np.ndarray):
            return self
        dev = device or jax.devices()[0]
        return Image(jax.device_put(self._array, dev), self.info)

    def to_device(self, device=None) -> "Image":
        return self.tpu(device)

    # -- interop ------------------------------------------------------------
    def __array__(self, dtype=None):
        a = np.asarray(self._array)
        return a.astype(dtype) if dtype is not None else a

    @property
    def __array_interface__(self):
        return self.cpu()._array.__array_interface__

    def __dlpack__(self, stream=None):
        return self._array.__dlpack__()

    def __dlpack_device__(self):
        return self._array.__dlpack_device__()

    @property
    def array(self):
        return self._array

    @property
    def jax(self):
        return self.tpu()._array

    def __repr__(self):
        where = "host" if isinstance(self._array, np.ndarray) else "tpu"
        return f"Image({self.shape}, {self.dtype}, {where})"


def as_image(source, info: Optional[ImageInfo] = None) -> Image:
    """Zero-copy import from array-likes / DLPack producers
    (reference: as_image / from_dlpack, python/module.cpp:89-150,
    python/image.cpp:165-218)."""
    if isinstance(source, Image):
        return source
    if isinstance(source, np.ndarray):
        return Image(source, info)
    if hasattr(source, "__dlpack__"):
        try:
            import jax

            return Image(jax.dlpack.from_dlpack(source), info)
        except Exception:
            return Image(np.from_dlpack(source), info)
    if hasattr(source, "__array_interface__") or hasattr(source, "__array__"):
        return Image(np.asarray(source), info)
    raise TypeError(f"cannot import image from {type(source)!r}")


def as_images(sources) -> list:
    return [as_image(s) for s in sources]


def from_dlpack(source) -> Image:
    return as_image(source)
