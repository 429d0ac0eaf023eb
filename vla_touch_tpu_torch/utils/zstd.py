"""zstd frames through the system's ``libzstd.so.1`` (``ctypes``; no build,
no header, no Python package).

``ctypes`` releases the interpreter lock around each foreign call, so the
thread pools of :mod:`utils.ocdbt` and :mod:`utils.zarr2` compress and
decompress chunks in parallel.  The library is looked up on first use,
never at import: :func:`library` raises ``OSError`` naming ``libzstd.so.1``
(and the file being read, where the caller gives one) when it is missing.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

import numpy as np

SONAME = "libzstd.so.1"
CONTENTSIZE_UNKNOWN = (1 << 64) - 1
CONTENTSIZE_ERROR = (1 << 64) - 2

_lib = None
_lock = threading.Lock()


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def _bind(lib):
    size_t, vp, cp = ctypes.c_size_t, ctypes.c_void_p, ctypes.c_char_p
    sigs = {
        "ZSTD_versionNumber": ([], ctypes.c_uint),
        "ZSTD_isError": ([size_t], ctypes.c_uint),
        "ZSTD_getErrorName": ([size_t], cp),
        "ZSTD_getFrameContentSize": ([vp, size_t], ctypes.c_ulonglong),
        "ZSTD_compressBound": ([size_t], size_t),
        "ZSTD_compress": ([vp, size_t, vp, size_t, ctypes.c_int], size_t),
        "ZSTD_decompress": ([vp, size_t, vp, size_t], size_t),
        "ZSTD_createDStream": ([], vp),
        "ZSTD_freeDStream": ([vp], size_t),
        "ZSTD_initDStream": ([vp], size_t),
        "ZSTD_DStreamOutSize": ([], size_t),
        "ZSTD_decompressStream": ([vp, ctypes.POINTER(_OutBuffer),
                                   ctypes.POINTER(_InBuffer)], size_t),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def find_library():
    """The path or soname ``ctypes`` loads libzstd from."""
    return ctypes.util.find_library("zstd") or SONAME


def library(reading: str = None):
    """The bound library (loaded once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            name = find_library()
            try:
                _lib = _bind(ctypes.CDLL(name))
            except (OSError, TypeError) as e:
                what = f" to read {reading}" if reading else ""
                raise OSError(f"zstd: {SONAME} is needed{what} and could not be "
                              f"loaded ({name}): {e}") from e
        return _lib


def version_number() -> int:
    """``ZSTD_versionNumber()``: 10504 for 1.5.4."""
    return int(library().ZSTD_versionNumber())


def _check(lib, ret: int, what: str) -> int:
    if lib.ZSTD_isError(ret):
        raise ValueError(f"zstd {what}: {lib.ZSTD_getErrorName(ret).decode()}")
    return ret


def _address(buf) -> tuple:
    """(pointer, byte length, keep-alive) of a contiguous bytes-like object,
    read-only ones (bytes, a read-only memory map) included, without a
    copy."""
    arr = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) \
        else buf.reshape(-1).view(np.uint8)
    return arr.ctypes.data, arr.size, arr


def compress(data, level: int = 1) -> memoryview:
    """One zstd frame of ``data`` (its content size recorded), as a view of
    the buffer it was compressed into (no zero fill, no copy)."""
    lib = library()
    src, n, keep = _address(data)
    out = np.empty(lib.ZSTD_compressBound(n), np.uint8)
    size = _check(lib, lib.ZSTD_compress(out.ctypes.data, out.size, src, n, level),
                  "compress")
    del keep
    return memoryview(out)[:size]


def decompress(data, reading: str = None, into=None):
    """The content of the zstd frame ``data`` (a bytearray).  ``into``: a
    writable buffer of the content's exact size to decompress into (then
    returned).  ``reading`` names the file in errors."""
    lib = library(reading)
    src, n, keep = _address(data)
    size = lib.ZSTD_getFrameContentSize(src, n)
    where = f" ({reading})" if reading else ""
    if size == CONTENTSIZE_ERROR:
        raise ValueError(f"zstd: not a zstd frame{where}")
    if size == CONTENTSIZE_UNKNOWN:
        out = _decompress_stream(lib, src, n, where)
        if into is None:
            return out
        if len(memoryview(into).cast("B")) != len(out):
            raise ValueError(f"zstd: frame holds {len(out)} bytes, buffer "
                             f"{len(memoryview(into).cast('B'))}{where}")
        memoryview(into).cast("B")[:] = out
        return into
    out = bytearray(size) if into is None else into
    dst, cap, keep_out = _address(out)
    if cap != size:
        raise ValueError(f"zstd: frame holds {size} bytes, buffer {cap}{where}")
    got = _check(lib, lib.ZSTD_decompress(dst, size, src, n), f"decompress{where}")
    del keep, keep_out
    if got != size:
        raise ValueError(f"zstd: frame gave {got} of {size} bytes{where}")
    return out


def _decompress_stream(lib, src: int, n: int, where: str) -> bytes:
    """A frame that does not record its size, through a ``ZSTD_DStream``."""
    ds = lib.ZSTD_createDStream()
    if not ds:
        raise MemoryError("ZSTD_createDStream")
    try:
        _check(lib, lib.ZSTD_initDStream(ds), "initDStream")
        step = lib.ZSTD_DStreamOutSize()
        chunk = ctypes.create_string_buffer(step)
        inb = _InBuffer(src, n, 0)
        parts = []
        while True:
            outb = _OutBuffer(ctypes.addressof(chunk), step, 0)
            ret = _check(lib, lib.ZSTD_decompressStream(ds, ctypes.byref(outb),
                                                        ctypes.byref(inb)),
                         f"decompressStream{where}")
            parts.append(ctypes.string_at(chunk, outb.pos))
            if ret == 0:
                return bytearray(b"".join(parts))
            if inb.pos >= inb.size and outb.pos < step:
                raise ValueError(f"zstd: truncated frame{where}")
    finally:
        lib.ZSTD_freeDStream(ds)
