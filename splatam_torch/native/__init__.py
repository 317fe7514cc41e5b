"""Native (C++) frame decoder: built on first use, bound with ctypes.

The port's copy of ``splatam_tpu/native``: ``frame_loader.cpp`` decodes
JPEG / PNG and resizes straight into float32 with the GIL released, so the
prefetch thread (``data/prefetch.py``) decodes beside the device work. It is
a host decoder, not a device kernel, and it stays optional: without ``g++``
or the libjpeg / libpng headers the loaders decode in Python.

The library is built into ``build/native/`` at the root of the checkout
(git-ignored), not next to its source.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "frame_loader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
_LIB = os.path.join(BUILD_DIR, "libframeloader.so")
_lock = threading.Lock()
_lib = None
_build_failed = False
build_error: Optional[str] = None  # why the build failed, if it did


def _build() -> bool:
    # compile to a pid-unique temporary path and rename it into place:
    # concurrent processes (parallel test workers) may build at once, and a
    # reader that dlopens a half-written .so gets an OSError
    global build_error
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp,
           "-ljpeg", "-lpng", "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except (subprocess.SubprocessError, FileNotFoundError, OSError) as e:
        err = getattr(e, "stderr", None)
        build_error = (err.decode(errors="replace").strip().splitlines()[0]
                       if err else str(e))
        print(f"[native] frame_loader build failed ({build_error}); "
              "decoding in Python")
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def load_library() -> Optional[ctypes.CDLL]:
    """Build (once) and load the library; None where it cannot be built."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not os.path.exists(_LIB) or (
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
        ):
            if not _build():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            # a stale or corrupt .so (left by a killed build): rebuild once
            if not _build():
                _build_failed = True
                return None
            lib = ctypes.CDLL(_LIB)
        lib.decode_jpeg_rgb_f32.restype = ctypes.c_int
        lib.decode_jpeg_rgb_f32.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.decode_png_f32.restype = ctypes.c_int
        lib.decode_png_f32.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ]
        lib.png_info_probe.restype = ctypes.c_int
        lib.png_info_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return _lib


class NativeFrameDecoder:
    """Decode and resize straight to float32 (ctypes drops the GIL per
    call)."""

    def __init__(self):
        self.lib = load_library()
        if self.lib is None:
            raise RuntimeError("native frame loader unavailable")

    def jpeg_rgb(self, path: str, out_h: int, out_w: int) -> np.ndarray:
        with open(path, "rb") as f:
            data = f.read()
        out = np.empty((out_h, out_w, 3), np.float32)
        rc = self.lib.decode_jpeg_rgb_f32(
            data, len(data), out_h, out_w,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc != 0:
            raise ValueError(f"jpeg decode failed ({rc}): {path}")
        return out

    def png(self, path: str, out_h: int, out_w: int, channels: int,
            nearest: bool) -> np.ndarray:
        with open(path, "rb") as f:
            data = f.read()
        out = np.empty((out_h, out_w, channels), np.float32)
        rc = self.lib.decode_png_f32(
            data, len(data), out_h, out_w, channels, 1 if nearest else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc != 0:
            raise ValueError(f"png decode failed ({rc}): {path}")
        return out

    def png_info(self, path: str):
        """(height, width, channels, bit depth) of a PNG file."""
        with open(path, "rb") as f:
            data = f.read()
        vals = [ctypes.c_int() for _ in range(4)]
        rc = self.lib.png_info_probe(data, len(data),
                                     *[ctypes.byref(v) for v in vals])
        if rc != 0:
            raise ValueError(f"png probe failed ({rc}): {path}")
        return tuple(v.value for v in vals)


def native_available() -> bool:
    return load_library() is not None
