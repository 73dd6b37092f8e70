"""ctypes bindings and the lazy build of the threaded frame loader.

``csrc/frameloader.cpp`` decodes JPEG and PNG frame files on C++ worker
threads (libjpeg / libpng, outside the GIL) and hands them to Python in
path order, so host decode overlaps the card's work on the batched video
path (``engine/pipeline.style_frames_batched``).

The shared library is built on first use with the host compiler
(``g++ -O3 -shared -fPIC … -ljpeg -lpng``) into ``neuralstyletransferv1_torch/
_build/`` (gitignored). Its name carries a hash of the source and the
flags, so an edited source rebuilds and an unchanged one is reused; the
compiler writes a temporary file that is renamed into place, so processes
that build at once do not race. Without g++ or the libjpeg / libpng
headers ``get_lib`` raises ``LoaderUnavailable`` and the engine reads the
frames with PIL instead, saying so.

Decoding: JPEG through the system libjpeg (within 1 level of PIL's
libjpeg-turbo, not equal to it; EXIF orientation is not applied), PNG
normalised to RGB8 as libpng's ``set_expand``, ``strip_16``,
``gray_to_rgb`` and ``strip_alpha`` do it (equal to PIL's ``convert("RGB")``
for opaque frames). A file the native decoders refuse is decoded with
``Image.open(p).convert("RGB")``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parent.parent
SRC = PKG / "csrc" / "frameloader.cpp"
BUILD_DIR = PKG / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]
LINK = ["-ljpeg", "-lpng"]

_lib = None
_error: str | None = None


class LoaderUnavailable(RuntimeError):
    """The loader cannot be built or loaded on this machine."""


def target() -> Path:
    """The library's path: ``_build/libframeloader_<hash>.so``."""
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join([CXX, *CXX_FLAGS, *LINK]).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libframeloader_{digest}.so"


def build() -> tuple[Path, str]:
    """Compile the loader unless it is built already; returns (library path,
    the compiler's output, empty when the file was reused). Raises
    ``LoaderUnavailable`` with the compiler's last lines on failure."""
    out = target()
    if out.exists():
        return out, ""
    cxx = shutil.which(CXX)
    if cxx is None:
        raise LoaderUnavailable(f"{CXX} not found")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(SRC), *LINK, "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise LoaderUnavailable(f"{CXX} failed to run: {e}") from e
    log = (res.stdout + res.stderr).strip()
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        tail = "\n".join(log.splitlines()[-8:])
        raise LoaderUnavailable(f"{CXX} failed (exit {res.returncode}): {tail}")
    os.replace(tmp, out)
    return out, log


def get_lib():
    """The loaded library, built on first use; raises ``LoaderUnavailable``
    (again on every later call) when it cannot be built or loaded."""
    global _lib, _error
    if _lib is not None:
        return _lib
    if _error is not None:
        raise LoaderUnavailable(_error)
    try:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
    except (LoaderUnavailable, OSError) as e:
        _error = str(e)
        raise LoaderUnavailable(_error) from e
    lib.fl_open.restype = ctypes.c_void_p
    lib.fl_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                            ctypes.c_int]
    lib.fl_next_info.restype = ctypes.c_int
    lib.fl_next_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int)]
    lib.fl_next_copy.restype = ctypes.c_int
    lib.fl_next_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.fl_close.restype = None
    lib.fl_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    try:
        get_lib()
    except LoaderUnavailable:
        return False
    return True


class NativeFrameLoader:
    """In-order iterator over the files' decoded RGB uint8 frames [H, W, 3],
    ``threads`` decoding up to ``capacity`` frames ahead. Raises
    ``LoaderUnavailable`` when the library cannot be built."""

    def __init__(self, paths, threads: int = 4, capacity: int = 16):
        self.paths = [str(p) for p in paths]
        self._lib = get_lib()
        self._names = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
        self._h = self._lib.fl_open(self._names, len(self.paths), threads, capacity)
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._i >= len(self.paths):
            raise StopIteration
        hh, ww = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.fl_next_info(self._h, ctypes.byref(hh), ctypes.byref(ww))
        if rc == -1:
            raise StopIteration
        if rc == -2:
            # refused by the native decoders: skip its slot, decode with PIL
            from PIL import Image

            self._lib.fl_next_copy(self._h, None)
            path = self.paths[self._i]
            self._i += 1
            return np.asarray(Image.open(path).convert("RGB"))
        out = np.empty((hh.value, ww.value, 3), np.uint8)
        self._lib.fl_next_copy(self._h, out.ctypes.data_as(ctypes.c_void_p))
        self._i += 1
        return out

    def close(self):
        if self._h:
            self._lib.fl_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
