"""Signature dispatch through the program store: the counterpart of the
JAX package's `compilecache/aot.py`.

`AotDispatch` fronts ONE callable — a train step, a bucketed forward, a
prefill, the decode loop's graph replay — and, per distinct argument
signature (shapes + dtypes + devices of tensors and arrays, the values
of static arguments, the container structure), asks the
`ProgramStore` whether that program was known before:

- a **hit**: the store holds the signature's entry (written by an
  earlier process, or by `warm()` in this one);
- a **miss**: it does not; the signature is recorded for the next
  process.

The wrapped callable ALWAYS runs as it does unwrapped, so outputs are
identical by construction. Torch has no serialized executable: what a
signature stands for is the work the first call at a new shape does on
the card (the allocator's and cuBLAS's first use of a shape, a CUDA
graph capture in the decode loop), and the port's warm hooks
(`InferenceEngine.warmup_from_plan`, `DecodeLoop.warm_programs`) are
what do that work before `/readyz`. `warm(spec...)` records a signature
WITHOUT running the callable; `TensorSpec` stands in for a tensor.

Every fault in the store (chaos, IO, a rejected entry) degrades to an
uncached call with the same result: it is counted in the store's
stats, never raised. `_cache_size()` counts the resident signatures
(plus whatever the wrapped object counts itself), so
`utils.jitcache.jit_cache_size` and every program-count pin built on it
see wrapped callables as one number.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
from typing import Any, Dict, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.compilecache.store import ProgramStore
from deeplearning4j_tpu_torch.utils.digest import config_digest

__all__ = ["AotCompiler", "AotDispatch", "TensorSpec", "config_digest"]

log = logging.getLogger(__name__)


class TensorSpec:
    """A tensor's signature without its data: what `warm()` takes in
    place of an argument (the port's `jax.ShapeDtypeStruct`). `dtype` is
    a torch or numpy dtype; `device` None matches a numpy array, a
    device matches a tensor on it."""

    __slots__ = ("shape", "dtype", "device")

    def __init__(self, shape, dtype, device=None):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype
        self.device = device

    @classmethod
    def like(cls, t) -> "TensorSpec":
        return cls(t.shape, t.dtype, getattr(t, "device", None))

    def __repr__(self) -> str:
        return (f"TensorSpec({self.shape}, {_dtype_name(self.dtype)}, "
                f"{self.device})")


def _dtype_name(dtype) -> str:
    text = str(dtype)
    if text.startswith("torch."):
        return text[len("torch."):]
    return np.dtype(dtype).name


def _leaf_sig(a, static: bool):
    """One leaf's signature entry."""
    if hasattr(a, "shape") and hasattr(a, "dtype"):
        dev = getattr(a, "device", None)
        if isinstance(a, np.ndarray) or dev is None:
            dev = None
        else:
            dev = str(dev)
        if isinstance(a, TensorSpec) and a.device is not None:
            dev = str(a.device)
        return ("t", tuple(int(d) for d in a.shape), _dtype_name(a.dtype),
                dev)
    if not static:
        if isinstance(a, (bool, int, float)):
            # a traced scalar: one program whatever its value
            return ("scalar", type(a).__name__)
        if not isinstance(a, (str, bytes, type(None))):
            # a state object (a guard, a generator): its type, not its
            # identity, is part of the program
            return ("obj", type(a).__qualname__)
    return ("py", repr(a))


def _sig(a, static: bool):
    if isinstance(a, dict):
        return ("dict", tuple((repr(k), _sig(a[k], static))
                              for k in sorted(a, key=repr)))
    if isinstance(a, (list, tuple)):  # namedtuples keep their type name
        return (type(a).__name__, tuple(_sig(v, static) for v in a))
    return _leaf_sig(a, static)


def _sig_entries(args: Sequence[Any], static: Sequence[int] = ()) -> Tuple:
    """Hashable per-argument signature: (shape, dtype, device) for
    tensors, arrays and TensorSpecs; at a non-static position the type
    of a python scalar or object and the repr of a string or None; the
    repr of everything at a static position; containers keep their
    structure."""
    return tuple(_sig(a, i in static) for i, a in enumerate(args))


class AotCompiler:
    """The bridge between dispatchers and a `ProgramStore`: an entry
    holds the JSON record of one signature. Shared by every
    `AotDispatch` in the process."""

    def __init__(self, store: ProgramStore):
        self.store = store

    def load(self, key: str, sig: Tuple) -> bool:
        """True when the store holds `key`'s entry for this signature. An
        entry that does not parse or names another signature is
        quarantined so it cannot fail again next boot."""
        payload = self.store.get(key)
        if payload is None:
            return False
        try:
            doc = json.loads(payload.decode())
            ok = doc.get("key") == key and doc.get("sig") == repr(sig)
        except (ValueError, UnicodeDecodeError, AttributeError):
            ok = False
        if not ok:
            log.warning("compile cache: entry for %s does not match its "
                        "signature — rebuilding", key)
            self.store.invalidate(key, reason="load_error")
        return ok

    def save(self, key: str, sig: Tuple) -> bool:
        """Commit the signature's record; False on a store fault (never
        raises)."""
        payload = json.dumps({"key": key, "sig": repr(sig)},
                             sort_keys=True).encode()
        return self.store.put(key, payload)


class AotDispatch:
    """Callable wrapper: store-backed signature dispatch over one
    callable (see module docstring). Drop-in: same call signature, same
    outputs."""

    def __init__(self, fn, *, key: str, compiler: AotCompiler,
                 static_argnums: Sequence[int] = ()):
        self._fn = fn
        self.key = key
        self._compiler = compiler
        self._static = tuple(static_argnums)
        self._programs: Dict[Tuple, bool] = {}   # sig -> known
        self._lock = threading.Lock()

    # ------------------------------------------------------------ keys
    def _store_key(self, sig: Tuple) -> str:
        digest = hashlib.sha256(repr(sig).encode()).hexdigest()[:24]
        return f"{self.key}:{digest}"

    def keys_for(self, *args) -> str:
        """The store key this argument list dispatches to (round-trip
        tests compare these across processes)."""
        return self._store_key(_sig_entries(args, self._static))

    # -------------------------------------------------------- dispatch
    def _obtain(self, sig: Tuple) -> None:
        """Look the signature up (a hit) or record it (a miss). A store
        fault only means the next process misses too."""
        key = self._store_key(sig)
        try:
            if self._compiler.load(key, sig):
                self._compiler.store.record_hit()
            else:
                self._compiler.store.record_miss()
                self._compiler.save(key, sig)
        except Exception as e:  # never surfaced to the caller
            log.warning("compile cache lookup for %s failed (%s: %s) — "
                        "running uncached", key, type(e).__name__, e)
        with self._lock:
            self._programs.setdefault(sig, True)

    def _known(self, sig: Tuple) -> bool:
        with self._lock:
            return sig in self._programs

    def __call__(self, *args):
        sig = _sig_entries(args, self._static)
        if not self._known(sig):
            self._obtain(sig)
        return self._fn(*args)

    # ---------------------------------------------------------- warmup
    def warm(self, *args) -> bool:
        """Look up or record the program for this argument signature
        WITHOUT running the callable. Arguments may be `TensorSpec`s;
        static arguments are passed as real values. Returns True (the
        signature is resident afterwards)."""
        sig = _sig_entries(args, self._static)
        if not self._known(sig):
            self._obtain(sig)
        return True

    # ------------------------------------------------------ accounting
    def _cache_size(self) -> int:
        """Resident signatures plus whatever the wrapped object counts
        itself. `utils.jitcache.jit_cache_size` calls this."""
        from deeplearning4j_tpu_torch.utils.jitcache import jit_cache_size

        inner = max(0, jit_cache_size(self._fn))
        with self._lock:
            return len(self._programs) + inner

    def aot_programs(self) -> int:
        with self._lock:
            return len(self._programs)

    def store_keys(self) -> set:
        """Store keys of the programs this dispatcher has resident."""
        with self._lock:
            sigs = list(self._programs)
        return {self._store_key(s) for s in sigs}

    # attribute passthrough to the wrapped callable
    def __getattr__(self, name):
        if name.startswith("__") or name in ("_fn",):
            raise AttributeError(name)
        return getattr(self._fn, name)
