"""Persistent program store: fingerprinted, crash-atomic, LRU — the
counterpart of the JAX package's `compilecache/store.py`.

The disk layer of the warm-start subsystem (see the package docstring
for what a "program" is in the port). A `ProgramStore` owns one cache
directory and keeps opaque payloads in it — the kernel library's bytes,
or a recorded argument signature — one file per program key, under a
RUNTIME FINGERPRINT subdirectory:

    <root>/v1/<fingerprint>/<key-digest>.xc

The fingerprint hashes what invalidates the port's programs: the torch
and CUDA versions, the device's name, compute capability and count,
`nvcc --version` where there is one, and CUBLAS_WORKSPACE_CONFIG — a
cache written under a different runtime is never even looked at. The
kernel sources' and flags' hash is not in it: the library's own key
(`kernels:<source hash>`) carries it, so an edited kernel misses its
library and leaves the recorded signatures and plans in place. On open,
any OTHER fingerprint's subtree is swept and counted as
`dl4j_compile_cache_evictions{reason="fingerprint"}`.

Entry format: a small header (magic + payload CRC32 + length) followed
by the payload. Writes are
crash-atomic with the repo's one durability idiom (utils/statefile.py,
checkpoint/format.py): tmp write -> fsync -> `os.replace`. A reader
can therefore see only the previous entry or the new one; anything
else (external truncation, a torn copy of the directory) fails the CRC
and is deleted — skipped, never loaded (`reason="torn"`).

Size is bounded by an LRU byte budget: after each write the store
evicts oldest-read entries (mtime order; `get` touches mtime) until
under budget (`reason="lru"`).

Fault injection: chaos points `compile.cache_write` (op="write" before
the tmp write, op="rename" before the commit rename) and
`compile.cache_read` (before each entry read). Every failure path —
injected or real IO — DEGRADES: `put` returns False, `get` returns
None, and the caller builds like the cache never existed. The cache
must never be able to take serving down. Host code.
"""

from __future__ import annotations

import binascii
import functools
import hashlib
import logging
import os
import shutil
import struct
import subprocess
from typing import Dict, Optional

from deeplearning4j_tpu_torch.testing import chaos

__all__ = ["ProgramStore", "runtime_fingerprint", "key_digest"]

log = logging.getLogger(__name__)

_MAGIC = b"DL4JXC1\n"
_HEADER = struct.Struct(">II")  # crc32, payload length
_LAYOUT = "v1"
_SUFFIX = ".xc"

#: default LRU byte budget (override per-store or via
#: DL4J_TPU_COMPILE_CACHE_BUDGET_MB)
DEFAULT_BUDGET_BYTES = 512 * 1024 * 1024
BUDGET_ENV = "DL4J_TPU_COMPILE_CACHE_BUDGET_MB"


@functools.lru_cache(maxsize=None)
def _nvcc_version() -> str:
    """`nvcc --version`'s last line, or "none" on a machine without the
    toolkit (the CPU lane builds nothing). Read once a process."""
    from deeplearning4j_tpu_torch import _build

    try:
        nvcc = _build.nvcc_path()
    except RuntimeError:
        return "none"
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return "none"
    lines = [line for line in out.splitlines() if line.strip()]
    return lines[-1] if lines else "none"


def runtime_fingerprint() -> str:
    """Digest of everything that can invalidate a stored program: torch
    and its CUDA version, the device's name, compute capability and
    count, the CUDA compiler and the cuBLAS workspace setting. Two
    processes with the same fingerprint can exchange programs; anything
    else must not even try. (The kernel sources are in the library's
    key, not here.)"""
    import torch

    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        name = torch.cuda.get_device_name(0)
        cc = "%d.%d" % torch.cuda.get_device_capability(0)
    else:
        n, name, cc = 0, "none", "none"
    parts = [
        f"torch={torch.__version__}",
        f"cuda={torch.version.cuda}",
        f"device={name}",
        f"cc={cc}",
        f"count={n}",
        f"nvcc={_nvcc_version()}",
        f"cublas_ws={os.environ.get('CUBLAS_WORKSPACE_CONFIG', '')}",
    ]
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def key_digest(key: str) -> str:
    """Stable filename for an arbitrary program key (keys embed shapes,
    dtypes, and config digests — too long and too hostile for paths)."""
    return hashlib.sha256(key.encode()).hexdigest()[:32]


class ProgramStore:
    """One compiled-program cache directory (see module docstring)."""

    def __init__(self, root: str, *,
                 size_budget_bytes: Optional[int] = None,
                 fingerprint: Optional[str] = None):
        self.root = os.path.abspath(root)
        if size_budget_bytes is None:
            mb = os.environ.get(BUDGET_ENV)
            size_budget_bytes = (int(float(mb) * 1024 * 1024) if mb
                                 else DEFAULT_BUDGET_BYTES)
        self.size_budget_bytes = int(size_budget_bytes)
        self.fingerprint = fingerprint or runtime_fingerprint()
        self.dir = os.path.join(self.root, _LAYOUT, self.fingerprint)
        from deeplearning4j_tpu_torch import telemetry

        reg = telemetry.get_registry()
        # the JAX package's series names; the help says what a hit is
        # in the port
        self._m_hits = reg.counter(
            "dl4j_compile_cache_hits",
            "store entries found: the kernel library loaded without "
            "nvcc, or an argument signature an earlier process recorded "
            "(the step itself still runs)")
        self._m_misses = reg.counter(
            "dl4j_compile_cache_misses",
            "store entries not found: the kernel library built by nvcc, "
            "or a signature met for the first time (then written back)")
        self._m_evict = reg.counter(
            "dl4j_compile_cache_evictions",
            "cache entries removed, by reason: lru (size budget), "
            "fingerprint (stale runtime quarantined), torn (failed "
            "CRC — skipped, never loaded), load_error (deserialize "
            "rejected the payload)")
        self._m_bytes = reg.gauge(
            "dl4j_compile_cache_bytes",
            "bytes held by the persistent compile cache (current "
            "fingerprint)")
        try:
            os.makedirs(self.dir, exist_ok=True)
            self._sweep_stale_fingerprints()
        except OSError as e:  # unusable dir: behave as always-miss
            log.warning("compile cache %s unusable: %s", self.root, e)
        self._m_bytes.set(self._bytes())

    # ------------------------------------------------------- fingerprint
    def _sweep_stale_fingerprints(self) -> None:
        """Quarantine-and-delete entries written by a different runtime.
        They live under a different subdirectory, so they were never
        loadable from this process to begin with — the sweep just
        reclaims the bytes and makes the defense visible in metrics."""
        base = os.path.join(self.root, _LAYOUT)
        try:
            names = os.listdir(base)
        except OSError:
            return
        for name in names:
            if name == self.fingerprint:
                continue
            stale = os.path.join(base, name)
            removed = 0
            for dirpath, _dirs, files in os.walk(stale, topdown=False):
                for fn in files:
                    try:
                        os.unlink(os.path.join(dirpath, fn))
                        if fn.endswith(_SUFFIX):
                            removed += 1
                    except OSError:
                        pass
                try:
                    os.rmdir(dirpath)
                except OSError:
                    pass
            shutil.rmtree(stale, ignore_errors=True)
            if removed:
                self._m_evict.labels(reason="fingerprint").inc(removed)
                log.info("compile cache: quarantined %d stale entries "
                         "(fingerprint %s != %s)", removed, name,
                         self.fingerprint)

    # ------------------------------------------------------------- paths
    def _path(self, key: str) -> str:
        return os.path.join(self.dir, key_digest(key) + _SUFFIX)

    def __contains__(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def keys(self) -> set:
        """Digests of the entries currently committed (the round-trip
        tests compare these sets across record/replay processes)."""
        try:
            return {fn[:-len(_SUFFIX)] for fn in os.listdir(self.dir)
                    if fn.endswith(_SUFFIX)}
        except OSError:
            return set()

    def _bytes(self) -> int:
        total = 0
        try:
            for fn in os.listdir(self.dir):
                if fn.endswith(_SUFFIX):
                    try:
                        total += os.path.getsize(
                            os.path.join(self.dir, fn))
                    except OSError:
                        pass
        except OSError:
            pass
        return total

    # --------------------------------------------------------------- put
    def put(self, key: str, payload: bytes) -> bool:
        """Commit one program payload crash-atomically. Returns False
        (and leaves any previous committed entry intact) on ANY failure
        — the caller already holds the program, so a failed write costs
        the NEXT process a build, nothing more."""
        path = self._path(key)
        tmp = path + ".tmp"
        blob = (_MAGIC
                + _HEADER.pack(binascii.crc32(payload) & 0xFFFFFFFF,
                               len(payload))
                + payload)
        try:
            chaos.hit("compile.cache_write", op="write", key=key)
            os.makedirs(self.dir, exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            chaos.hit("compile.cache_write", op="rename", key=key)
            os.replace(tmp, path)
        except BaseException as e:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            log.warning("compile cache write %s failed (%s: %s) — "
                        "degrading to a plain build next boot",
                        key_digest(key), type(e).__name__, e)
            if not isinstance(e, Exception):  # KeyboardInterrupt etc.
                raise
            return False
        self.gc()
        return True

    # --------------------------------------------------------------- get
    def get(self, key: str) -> Optional[bytes]:
        """The committed payload for `key`, or None (missing, torn, or
        faulted — all of which mean "build it yourself"). A torn
        entry is deleted on sight so it cannot keep failing CRC on
        every boot."""
        path = self._path(key)
        try:
            chaos.hit("compile.cache_read", key=key)
            with open(path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return None
        except Exception as e:
            log.warning("compile cache read %s failed (%s: %s) — "
                        "building instead", key_digest(key),
                        type(e).__name__, e)
            return None
        payload = self._validate(blob)
        if payload is None:
            self.invalidate(key, reason="torn")
            return None
        try:  # LRU touch: a loaded program is a recently-used program
            os.utime(path)
        except OSError:
            pass
        return payload

    def _validate(self, blob: bytes) -> Optional[bytes]:
        if len(blob) < len(_MAGIC) + _HEADER.size:
            return None
        if not blob.startswith(_MAGIC):
            return None
        crc, length = _HEADER.unpack_from(blob, len(_MAGIC))
        payload = blob[len(_MAGIC) + _HEADER.size:]
        if len(payload) != length:
            return None
        if binascii.crc32(payload) & 0xFFFFFFFF != crc:
            return None
        return payload

    def invalidate(self, key: str, *, reason: str) -> None:
        """Delete one entry and count the eviction (torn bytes, or a
        payload its loader rejected)."""
        try:
            os.unlink(self._path(key))
        except OSError:
            pass
        self._m_evict.labels(reason=reason).inc()
        log.warning("compile cache entry %s evicted (%s)",
                    key_digest(key), reason)

    # ---------------------------------------------------------------- gc
    def gc(self) -> int:
        """Evict least-recently-used entries until under the byte
        budget; returns the number evicted. Runs after every put."""
        try:
            entries = []
            for fn in os.listdir(self.dir):
                if not fn.endswith(_SUFFIX):
                    continue
                p = os.path.join(self.dir, fn)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                entries.append((st.st_mtime, st.st_size, p))
        except OSError:
            return 0
        total = sum(size for _, size, _ in entries)
        evicted = 0
        if total > self.size_budget_bytes:
            for _mtime, size, p in sorted(entries):
                if total <= self.size_budget_bytes:
                    break
                try:
                    os.unlink(p)
                except OSError:
                    continue
                total -= size
                evicted += 1
            if evicted:
                self._m_evict.labels(reason="lru").inc(evicted)
        self._m_bytes.set(total)
        return evicted

    # ------------------------------------------------------------- stats
    def record_hit(self) -> None:
        self._m_hits.inc()

    def record_miss(self) -> None:
        self._m_misses.inc()

    def evictions(self) -> Dict[str, int]:
        return {labels.get("reason", "?"): int(child.value)
                for labels, child in self._m_evict.children()}

    def stats(self) -> dict:
        """The /stats "compile_cache" section (process-global counters
        next to this store's directory identity)."""
        return {
            "dir": self.root,
            "fingerprint": self.fingerprint,
            "entries": len(self.keys()),
            "bytes": self._bytes(),
            "size_budget_bytes": self.size_budget_bytes,
            "hits": int(self._m_hits.value),
            "misses": int(self._m_misses.value),
            "evictions": self.evictions(),
        }
