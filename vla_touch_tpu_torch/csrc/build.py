"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use, one ``nvcc`` per source and all sources at once::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<name>.<hash>.so csrc/<name>.cu

into ``build/kernels/`` beside the package (``.gitignore`` lists ``build/``).
The file name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  Libraries load with
``ctypes``; every C entry returns ``cudaGetLastError()`` and
:func:`check` raises when it is not 0.  The hash covers the source and
``NVCC_FLAGS``.  Every build adds ``-Xptxas -v``, which does not change the
code, and keeps the compiler's report (registers, shared memory, spills)
beside the library as ``<name>.<hash>.ptxas``: :func:`ptxas_report` reads
it whether this process compiled the library or found it built.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC.parents[1] / "build" / "kernels"
SOURCES = ("flash_attention", "resblock", "a8w8_matmul", "w4a8_matmul",
           "flash_attention_q8", "w4_swiglu", "w4_postattn", "a8w8_matmul_large",
           "w8a16_matmul")
# one build at a time in a process: a serving pool's dispatcher thread may
# load a library while the main thread does
_BUILD_LOCK = threading.Lock()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for inc in sorted(CSRC.glob("*.cuh")):
        src += inc.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}.{digest}.so"


def _report_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas")


def build_all(verbose: bool = False) -> dict:
    """Compile every kernel library whose library or report is missing, in
    parallel; returns {name: path}.  ``verbose`` prints the compiler's
    report of each source it compiles."""
    flags = NVCC_FLAGS + ("-Xptxas", "-v")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    todo = {name: p for name, p in paths.items()
            if not (p.exists() and _report_path(p).exists())}
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu failed ---\n{out}")
            continue
        report_tmp = tmp.with_suffix(".ptxas")
        report_tmp.write_text(out)
        os.replace(report_tmp, _report_path(path))
        os.replace(tmp, path)
        if verbose:
            print(f"--- nvcc {name}.cu ---\n{out}", flush=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` report of kernel library ``name``'s build (built
    first if missing)."""
    path = _report_path(_lib_path(name))
    if not path.exists():
        with _BUILD_LOCK:
            build_all()
    return path.read_text()


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built first if missing)."""
    with _BUILD_LOCK:
        path = _lib_path(name)
        if not path.exists():
            path = build_all()[name]
    lib = ctypes.CDLL(str(path))
    lib.vtt_error_string.argtypes = [ctypes.c_int]
    lib.vtt_error_string.restype = ctypes.c_char_p
    return lib


def entry(name: str, argtypes: list, symbol: str | None = None):
    """(library, C entry) of kernel library ``name``: the entry ``symbol``
    (default ``name``) with ``argtypes`` declared, returning a CUDA error
    code for :func:`check`."""
    lib = library(name)
    f = getattr(lib, symbol or name)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib, f


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry of ``lib`` returned a CUDA error."""
    if err != 0:
        msg = lib.vtt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def refuse_grad(what: str, route: str | None, *operands) -> None:
    """Raise where a kernel would run under autograd: under
    ``torch.is_grad_enabled()``, with a floating operand that requires grad.
    The kernels write through raw pointers, so their outputs have no
    ``grad_fn`` and every gradient through them would be cut silently.
    ``route``: the autograd Function to call instead, or None where there
    is none (the JAX package gives that kernel no differentiation rule)."""
    import torch

    if not torch.is_grad_enabled():
        return
    if not any(t is not None and t.is_floating_point() and t.requires_grad for t in operands):
        return
    how = (f"call {route} (the autograd route) instead" if route else
           "it has no autograd route (nor has the JAX package's kernel a differentiation "
           "rule); call it under torch.no_grad()")
    raise RuntimeError(f"{what}: an operand requires grad; {how}")
