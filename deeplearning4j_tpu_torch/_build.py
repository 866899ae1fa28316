"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every `csrc/*.cu` file is compiled by its own `nvcc` process (all started
together) for `sm_90a`, then linked into one shared library with a plain
C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c csrc/<name>.cu          (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared *.o \
         -o build/kernels/<hash>/libdl4j_kernels.so

The output directory is keyed on a hash of the sources and the flags, so
an edited kernel never loads a stale library. `build/` sits at the root
of the checkout and is git-ignored. The sources include no PyTorch
header, which keeps a build to seconds.

The library is loaded with `ctypes`; every pointer and the stream are
`c_void_p` (a bare Python int would be cut to 32 bits), ints are
`c_int`, and each entry point returns its `cudaError_t`, which the
wrappers turn into an exception when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "kernels"
LIB_NAME = "libdl4j_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signature of every entry point: (argtypes, restype)
SIGNATURES = {
    # q, k, v, out, lse|NULL, bh, tq, tk, hd, dtype, causal, stream
    "dl4j_flash_fwd": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
                       _I),
    # q, k, v, dout, lse, dd, dq, bh, tq, tk, hd, dtype, causal, stream
    "dl4j_flash_bwd_dq": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _P], _I),
    # q, k, v, dout, lse, dd, dk, dv, bh, tq, tk, hd, dtype, causal, stream
    "dl4j_flash_bwd_dkv": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _P], _I),
    # q, k_pool, v_pool, page_table, lengths, out, partial (scratch),
    # slots, heads, page_size, table_width, pages_per_split, hd, dtype,
    # stream
    "dl4j_paged_decode": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _P], _I),
}

_lock = threading.Lock()
_lib = None
#: wall seconds the last `build()` spent compiling (0.0 on a cache hit)
build_seconds = None


def nvcc_path() -> str:
    """`$CUDA_HOME/bin/nvcc`, else `nvcc` on PATH, else the toolkit's
    usual place."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from source at first "
        "use and need the CUDA toolkit (set CUDA_HOME)")


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless a library for these exact sources is
    already built; return its path. The compiler's per-kernel register
    and shared-memory report (`-Xptxas -v`) lands in `build.log` beside
    the library."""
    global build_seconds
    out_dir = BUILD_ROOT / source_digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        build_seconds = 0.0
        return lib
    start = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}.{threading.get_ident()}"
    objs, procs = [], []
    for src in sources():
        obj = out_dir / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    build_seconds = time.perf_counter() - start
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero `cudaError_t` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
