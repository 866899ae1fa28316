"""ctypes loader for the port's native host runtime, with numpy fallbacks:
the counterpart of the JAX package's `runtime/native_loader.py`, with
the same API (`native_available`, `read_idx`, `read_csv`, `BatchQueue`).

`runtime/native/native.cpp` is built at first use, out of the package
tree, into

    build/native/<hash of source and flags>/libdl4j_native.so

with `g++ -O3 -shared -fPIC -std=c++17 -pthread` (about a second), the
way `_build.py` keys `build/kernels/`: an edited source never loads a
stale library, and nothing is written next to the sources. `build/`
sits at the root of the checkout and is git-ignored. The library is
published by `os.replace`, so concurrent first users see all of it or
none.

On a box without `g++` every entry point falls back to numpy /
`queue.Queue`, as the JAX package documents; `native_available()` says
which path is live, and a caller that must not fall back checks it.
The CPython boundary is ctypes, with buffer ownership handed to numpy
by an explicit free.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import struct
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "native" / "native.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_NAME = "libdl4j_native.so"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lib_path: Optional[Path] = None
_lib_lock = threading.Lock()
_build_failed = False


def library_dir() -> Path:
    """`build/native/<hash>/`: the hash covers the source and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError) as e:
        log.warning("native build failed (%s); using numpy fallbacks", e)
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def _load():
    """Build (if needed) and load the shared library; None on failure."""
    global _lib, _lib_path, _build_failed
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        so = library_dir() / LIB_NAME
        if not so.exists() and not _build(so):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            log.warning("native load failed (%s)", e)
            _build_failed = True
            return None
        lib.dl4j_idx_read.restype = ctypes.c_int
        lib.dl4j_idx_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
        lib.dl4j_csv_read.restype = ctypes.c_int
        lib.dl4j_csv_read.argtypes = [
            ctypes.c_char_p, ctypes.c_char,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.dl4j_buffer_free.argtypes = [ctypes.c_void_p]
        lib.dl4j_queue_create.restype = ctypes.c_void_p
        lib.dl4j_queue_create.argtypes = [ctypes.c_int64]
        lib.dl4j_queue_push.restype = ctypes.c_int
        lib.dl4j_queue_push.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_uint8),
                                        ctypes.c_int64]
        lib.dl4j_queue_pop.restype = ctypes.c_int64
        lib.dl4j_queue_pop.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
        lib.dl4j_queue_size.restype = ctypes.c_int64
        lib.dl4j_queue_size.argtypes = [ctypes.c_void_p]
        lib.dl4j_queue_close.argtypes = [ctypes.c_void_p]
        lib.dl4j_queue_destroy.argtypes = [ctypes.c_void_p]
        _lib, _lib_path = lib, so
        return _lib


def native_available() -> bool:
    return _load() is not None


def library_path() -> Optional[Path]:
    """The loaded library's path (None when the numpy fallbacks are
    live)."""
    _load()
    return _lib_path


# ------------------------------------------------------------------- IDX
def read_idx(path: str) -> np.ndarray:
    """Read an IDX file into a uint8 ndarray (native; numpy fallback)."""
    lib = _load()
    if lib is None:
        return _read_idx_numpy(path)
    data = ctypes.POINTER(ctypes.c_uint8)()
    dims = (ctypes.c_int64 * 4)()
    ndim = ctypes.c_int()
    rc = lib.dl4j_idx_read(str(path).encode(), ctypes.byref(data), dims,
                           ctypes.byref(ndim))
    if rc != 0:
        raise ValueError(f"IDX read failed for {path} (code {rc})")
    shape = tuple(int(dims[i]) for i in range(ndim.value))
    n = int(np.prod(shape))
    try:
        arr = np.ctypeslib.as_array(data, shape=(n,)).reshape(shape).copy()
    finally:
        lib.dl4j_buffer_free(data)
    return arr


def _read_idx_numpy(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        zero1, zero2, dtype, ndim = struct.unpack(">BBBB", f.read(4))
        if zero1 or zero2 or dtype != 0x08:
            raise ValueError(f"Bad IDX header in {path}")
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape).copy()


# ------------------------------------------------------------------- CSV
def read_csv(path: str, delimiter: str = ",") -> np.ndarray:
    """Numeric CSV -> float32 matrix (native; numpy fallback)."""
    lib = _load()
    if lib is None:
        # comments=None: the native parser rejects '#' lines as unparsable,
        # so the fallback must too — behaviour must not depend on whether
        # the library loaded
        return np.loadtxt(path, delimiter=delimiter,
                          dtype=np.float32, ndmin=2, comments=None)
    data = ctypes.POINTER(ctypes.c_float)()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.dl4j_csv_read(str(path).encode(), delimiter.encode(),
                           ctypes.byref(data), ctypes.byref(rows),
                           ctypes.byref(cols))
    if rc != 0:
        raise ValueError(f"CSV read failed for {path} (code {rc})")
    try:
        arr = np.ctypeslib.as_array(
            data, shape=(rows.value * cols.value,)).reshape(
                rows.value, cols.value).copy()
    finally:
        lib.dl4j_buffer_free(data)
    return arr


# ---------------------------------------------------------- batch queue
class BatchQueue:
    """Bounded producer/consumer queue over the native ring (double
    buffering between host batch assembly and the device step). Items are
    float32 ndarrays; the shape travels in a 5-int64 header. The
    pure-Python fallback uses queue.Queue."""

    def __init__(self, capacity: int = 4):
        self._lib = _load()
        if self._lib is not None:
            self._handle = self._lib.dl4j_queue_create(capacity)
            self._py = None
        else:
            import queue
            self._handle = None
            self._py = queue.Queue(maxsize=capacity)
        self._closed = False

    @staticmethod
    def _pack(arr: np.ndarray) -> np.ndarray:
        arr = np.ascontiguousarray(arr, np.float32)
        if arr.ndim > 4:
            raise ValueError(
                f"BatchQueue supports ndim <= 4, got ndim={arr.ndim} "
                "(the 5-int64 wire header carries at most 4 dims)")
        header = np.array([arr.ndim, *arr.shape, *([0] * (4 - arr.ndim))],
                          np.int64)
        return np.concatenate([header.view(np.uint8),
                               arr.ravel().view(np.uint8)])

    @staticmethod
    def _unpack(buf: np.ndarray) -> np.ndarray:
        header = buf[:40].view(np.int64)
        ndim = int(header[0])
        shape = tuple(int(d) for d in header[1:1 + ndim])
        return buf[40:].view(np.float32).reshape(shape).copy()

    def push(self, arr: np.ndarray) -> bool:
        """Blocking; returns False if the queue is closed."""
        if self._py is not None:
            if self._closed:
                return False
            self._py.put(np.asarray(arr, np.float32))
            return True
        packed = self._pack(arr)
        ptr = packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        return self._lib.dl4j_queue_push(self._handle, ptr,
                                         packed.size) == 0

    def pop(self) -> Optional[np.ndarray]:
        """Blocking; None when closed and drained."""
        if self._py is not None:
            import queue
            while True:
                try:
                    return self._py.get(timeout=0.05)
                except queue.Empty:
                    if self._closed:
                        return None
        data = ctypes.POINTER(ctypes.c_uint8)()
        n = self._lib.dl4j_queue_pop(self._handle, ctypes.byref(data))
        if n < 0:
            return None
        try:
            buf = np.ctypeslib.as_array(data, shape=(n,)).copy()
        finally:
            self._lib.dl4j_buffer_free(data)
        return self._unpack(buf)

    def size(self) -> int:
        if self._py is not None:
            return self._py.qsize()
        return int(self._lib.dl4j_queue_size(self._handle))

    def close(self) -> None:
        self._closed = True
        if self._py is None:
            self._lib.dl4j_queue_close(self._handle)

    def __del__(self):
        try:
            if getattr(self, "_py", True) is None and self._handle:
                self._lib.dl4j_queue_destroy(self._handle)
                self._handle = None
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
