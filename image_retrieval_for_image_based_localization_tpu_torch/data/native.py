"""ctypes bindings for the repository's native (C++) image preprocessing.

``native/preproc.cpp`` decodes JPEG/PNG files, crops, and max-side resizes
(bilinear, or the reference's antialiased LANCZOS) straight into padded
NHWC uint8 batch buffers, on several host threads. The JAX package's
extractor decodes path inputs with it by default; this module gives the port
the same library, so both packages feed the trunk the same pixels.

The library is compiled from ``native/preproc.cpp`` at first use, with the
flags of ``native/Makefile``, into ``build/native_preproc/`` at the root of
the checkout, keyed by the SHA-256 of the source (an edited source is
rebuilt, a stale library never loaded). It needs a C++ compiler and the
libjpeg and libpng headers; where the build or the load fails the library
is reported unavailable and the extractor keeps to PIL, the JAX package's
rule. This is host decode only: no device work depends on it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "preproc.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "native_preproc")
# native/Makefile's CXXFLAGS and LIBS
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")
LIBS = ("-ljpeg", "-lpng", "-lpthread")
_ABI_VERSION = 2  # must match irtpu_abi_version() in preproc.cpp

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def library_path() -> str:
    """Where ``native/preproc.cpp`` builds to, keyed by its contents."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libirtpu_preproc-{digest}.so")


def _build(out: str) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *CXXFLAGS, "-o", tmp, SOURCE, *LIBS], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    with _lock:
        if _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        so = library_path()
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        if not hasattr(lib, "irtpu_abi_version") or lib.irtpu_abi_version() != _ABI_VERSION:
            return None
        lib.irtpu_preprocess_batch_u8.restype = ctypes.c_int
        lib.irtpu_preprocess_batch_u8.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,  # filter
            ctypes.c_int,  # nthreads
        ]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    """True where the native library builds (or is built) and loads."""
    return _load() is not None


def preprocess_batch_native(
    paths: Sequence[str],
    image_size: int,
    out_h: int,
    out_w: int,
    bbxs: Optional[Sequence] = None,
    nthreads: int = 0,
    upscale: bool = True,
    resize_filter: str = "bilinear",
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode, crop and resize ``paths`` into a padded batch.

    ``nthreads``: decode threads, 0 for one an image up to the host's
    cores. ``upscale=False`` shrinks only (the reference's thumbnail);
    ``resize_filter='lanczos'`` is the reference's antialiased LANCZOS.
    Returns (pixels [n, out_h, out_w, 3] uint8, raw: the extractor
    normalizes on the device; sizes [n, 2] int32 valid (h, w), (0, 0) for a
    failed decode).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native preproc library unavailable (needs a C++ compiler and "
                           "the libjpeg and libpng headers)")
    n = len(paths)
    out = np.zeros((n, out_h, out_w, 3), np.uint8)
    sizes = np.zeros((n, 2), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    bbx_arr = None
    bbx_ptr = ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
    if bbxs is not None and any(b is not None for b in bbxs):
        bbx_arr = np.zeros((n, 4), np.float32)
        for i, b in enumerate(bbxs):
            bbx_arr[i] = b if b is not None else (0, 0, 10**8, 10**8)
        bbx_ptr = bbx_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    try:
        filt = {"bilinear": 0, "lanczos": 1}[resize_filter]
    except KeyError:
        raise ValueError(f"unknown resize filter {resize_filter!r} (bilinear|lanczos)")
    lib.irtpu_preprocess_batch_u8(
        c_paths,
        n,
        image_size if upscale else -image_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        out_h,
        out_w,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        bbx_ptr,
        filt,
        nthreads if nthreads > 0 else min(n, os.cpu_count() or 4),
    )
    return out, sizes
