"""ctypes binding of the native batched image loader (the repository's
``native/image_loader.cpp``).

Port of the JAX package's ``utils/native_images.py``: `load_image_batch`
decodes PNG/JPEG files into one (N, size, size, 3) uint8 array, with
multithreaded libpng/libjpeg decoding and a bilinear resize, the fast path
of `data.datasets._load_image_dir`. The library is built with g++ at first
use (linked with ``-lpng -ljpeg -lz -lpthread``) into ``csrc/build/``
(`ops._build.build_host`), never into ``native/``. Where it cannot be built
(no g++, no ``png.h`` or ``jpeglib.h``), `load_image_batch` returns None,
as the JAX binding does, and callers decode with PIL; that is said once, in
a warning naming what was missing.
"""

from __future__ import annotations

import ctypes
import functools
import os
import warnings
from typing import Optional, Sequence

import numpy as np

from ..ops import _build

SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "image_loader.cpp",
)
LIBS = ("-lpng", "-ljpeg", "-lz", "-lpthread")


@functools.cache
def _library() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(_build.build_host(SOURCE, LIBS))
    except (RuntimeError, OSError) as e:
        warnings.warn(f"the native image loader is unavailable ({e}); "
                      "image directories are decoded one file at a time with PIL",
                      RuntimeWarning)
        return None
    lib.load_images.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
    ]
    lib.load_images.restype = ctypes.c_int64
    return lib


def native_available() -> bool:
    return _library() is not None


def load_image_batch(
    paths: Sequence[str], size: int, n_threads: int = 0
) -> Optional[np.ndarray]:
    """(N, size, size, 3) uint8 from image files, or None if the library is
    unavailable. Raises FileNotFoundError / ValueError for a missing or
    undecodable file (a format the decoder lacks, such as webp), so that
    data problems surface instead of silently falling back."""
    lib = _library()
    if lib is None or not paths:
        return None
    out = np.empty((len(paths), size, size, 3), dtype=np.uint8)
    arr = (ctypes.c_char_p * len(paths))(*[os.fspath(p).encode() for p in paths])
    rc = lib.load_images(
        arr, len(paths), size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads,
    )
    if rc != 0:
        bad = paths[rc - 1]
        if not os.path.exists(bad):
            raise FileNotFoundError(bad)
        raise ValueError(f"could not decode image: {bad}")
    return out
