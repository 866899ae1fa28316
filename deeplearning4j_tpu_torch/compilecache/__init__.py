"""Warm start: the persistent program store and warmup plans — the
counterpart of the JAX package's `compilecache/`.

The JAX package serializes XLA executables. Torch has no such thing, so
a "program" in the port is one of three things:

(a) **the kernel library**: `_build.py`'s `libdl4j_kernels.so`, the one
    artifact the port compiles. With a cache active, `_build.build()`
    puts it into the store under `kernels:<source hash>` after a build,
    and a process whose `build/kernels/<hash>/` is empty loads it from
    the store instead of running `nvcc`. A missing or quarantined entry
    means `nvcc` builds the library, as without a cache — never the
    plain PyTorch version: the kernel lane is the same in every case.
(b) **an argument signature** of a wrapped step — shapes, dtypes,
    device and static arguments — which is what the port's program
    counters count (a train step's batch shapes, an engine's bucket
    shapes, the decode loop's prefill groups). `AotDispatch` records
    each signature in the store; a hit means the dispatcher knew the
    program before the call. The wrapped callable always runs as it
    does unwrapped, so outputs are identical by construction.
(c) **the CUDA graphs** the decode loop captures. They cannot be
    stored; a warmup plan captures them again before `/readyz`.

- `store`   — fingerprinted, crash-atomic, LRU-bounded on-disk store;
- `aot`     — `AotDispatch`, the signature dispatcher over the store;
- `warmup`  — JSON warmup plans (the JAX package's format): record the
              program set one replica used, replay it on the next boot
              through the port's warm hooks
              (`InferenceEngine.warmup_from_plan` runs the recorded
              buckets, `DecodeLoop.warm_programs` the recorded prefill
              groups and captures the step and verify graphs).

Process activation model: ONE optional process-global compiler. When
inactive (the default — no env var, no `activate()` call) every hook
in the tree is inert: `maybe_wrap` is an identity function, and
`bind_program` returns None, so the object calls its own method and
keeps nothing. With a store active, `bind_program` holds the method
through a weak reference to its owner: a dispatcher kept on the object
it serves makes no reference cycle, and networks, engines and loops are
freed by refcount either way. Activation happens explicitly (`cli serve
--compile-cache DIR`, `serve_network(compile_cache=...)`) or lazily
from the environment: spawners stamp `DL4J_TPU_COMPILE_CACHE` into
child environments (`export_env`), so fleet members, pipeline
replicas, and elastic workers inherit the cache with no per-call-site
plumbing. Host code throughout.
"""

from __future__ import annotations

import logging
import os
import threading
import weakref
from typing import Optional

from deeplearning4j_tpu_torch.compilecache.aot import (  # noqa: F401
    AotCompiler,
    AotDispatch,
    TensorSpec,
    config_digest,
)
from deeplearning4j_tpu_torch.compilecache.store import (  # noqa: F401
    ProgramStore,
    key_digest,
    runtime_fingerprint,
)

__all__ = [
    "CACHE_ENV",
    "ProgramStore", "AotCompiler", "AotDispatch", "TensorSpec",
    "config_digest", "key_digest", "runtime_fingerprint",
    "activate", "deactivate", "active_compiler", "active_dir",
    "maybe_wrap", "bind_program", "export_env",
    "default_dir_for_checkpoints", "stats",
]

log = logging.getLogger(__name__)

#: child processes find their cache dir here (spawners set it; see
#: `export_env`)
CACHE_ENV = "DL4J_TPU_COMPILE_CACHE"

_lock = threading.Lock()
_compiler: Optional[AotCompiler] = None
_env_checked = False


def activate(root: str, *, size_budget_bytes: Optional[int] = None,
             fingerprint: Optional[str] = None) -> AotCompiler:
    """Open (or switch to) the persistent cache at `root` for this
    process and export it to future children via the environment.
    Idempotent for the same root."""
    global _compiler, _env_checked
    root = os.path.abspath(root)
    with _lock:
        if _compiler is not None and _compiler.store.root == root:
            return _compiler
        _compiler = AotCompiler(ProgramStore(
            root, size_budget_bytes=size_budget_bytes,
            fingerprint=fingerprint))
        _env_checked = True
        os.environ[CACHE_ENV] = root
        log.info("compile cache active at %s (fingerprint %s)",
                 root, _compiler.store.fingerprint)
        return _compiler


def deactivate() -> None:
    """Drop the process-global compiler and the env export. Callables
    already wrapped keep their resident programs; new `maybe_wrap` calls
    become identity again. (Primarily for tests.)"""
    global _compiler, _env_checked
    with _lock:
        _compiler = None
        _env_checked = True
        os.environ.pop(CACHE_ENV, None)


def active_compiler() -> Optional[AotCompiler]:
    """The process compiler, auto-activating once from
    `DL4J_TPU_COMPILE_CACHE` — how spawned children pick up the cache
    their parent exported without any code path knowing about it."""
    global _compiler, _env_checked
    with _lock:
        if _compiler is None and not _env_checked:
            _env_checked = True
            root = os.environ.get(CACHE_ENV)
            if root:
                try:
                    _compiler = AotCompiler(ProgramStore(root))
                    log.info("compile cache activated from env: %s",
                             root)
                except Exception as e:
                    log.warning("compile cache env activation failed "
                                "(%s: %s) — running uncached",
                                type(e).__name__, e)
        return _compiler


def active_dir() -> Optional[str]:
    comp = active_compiler()
    return comp.store.root if comp is not None else None


def maybe_wrap(fn, key: Optional[str], *, static_argnums=()):
    """The one hook call sites use: wrap `fn` in an `AotDispatch` when a
    cache is active and a key is given, else return it untouched. Call
    sites therefore carry zero cache logic and zero behavior change
    when the subsystem is off."""
    if key is None:
        return fn
    comp = active_compiler()
    if comp is None:
        return fn
    return AotDispatch(fn, key=key, compiler=comp,
                       static_argnums=static_argnums)


class _WeakBound:
    """A bound method held through a weak reference to its owner, with
    leading arguments: what `bind_program` wraps, so that a dispatcher
    stored on its owner makes no reference cycle."""

    __slots__ = ("_owner", "_func", "_args")

    def __init__(self, method, *args):
        self._owner = weakref.ref(method.__self__)
        self._func = method.__func__
        self._args = args

    def __call__(self, *args):
        owner = self._owner()
        if owner is None:
            raise ReferenceError("the program's owner was freed")
        return self._func(owner, *self._args, *args)


def bind_program(method, key: Optional[str], *args, static_argnums=()):
    """The hook for a bound method an object keeps: an `AotDispatch`
    over `method` (with `args` in front of the call's own) when a cache
    is active and a key is given, held weakly (see `_WeakBound`); None
    otherwise, and the caller then calls `method` itself and stores
    nothing."""
    if key is None:
        return None
    comp = active_compiler()
    if comp is None:
        return None
    return AotDispatch(_WeakBound(method, *args), key=key, compiler=comp,
                       static_argnums=static_argnums)


def export_env(env: dict) -> dict:
    """Stamp the active cache dir into a child-process environment
    (spawners call this; no-op when inactive or already set by the
    caller). Returns `env` for chaining."""
    comp = active_compiler()
    if comp is not None and CACHE_ENV not in env:
        env[CACHE_ENV] = comp.store.root
    return env


def default_dir_for_checkpoints(checkpoint_dir: str) -> str:
    """`--compile-cache auto`: co-locate the program cache with the
    checkpoint dir, so whatever ships/mounts checkpoints ships the
    kernel library and the warmup plans too."""
    return os.path.join(os.path.abspath(checkpoint_dir),
                        "compile_cache")


def stats() -> Optional[dict]:
    """The active store's stats dict (the /stats "compile_cache"
    section), or None when inactive."""
    comp = active_compiler()
    return comp.store.stats() if comp is not None else None
