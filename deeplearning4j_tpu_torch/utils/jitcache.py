"""Program counting, the counterpart of the JAX package's
`utils/jitcache.py`.

The recompile counters (train_step_cache_size, predict_step_cache_size,
InferenceEngine.program_cache_size, DecodeLoop.decode_step_programs) all
count what an object has built; one helper reads whichever an object
exposes, so a store-wrapped callable and a plain one report alike."""

from __future__ import annotations

__all__ = ["jit_cache_size"]

#: the counters an object may expose, in the order they are read
_COUNTERS = ("_cache_size", "program_cache_size", "train_step_cache_size",
             "decode_step_programs")


def jit_cache_size(obj) -> int:
    """Number of programs `obj` counts: `AotDispatch._cache_size`, an
    engine's `program_cache_size`, a network's `train_step_cache_size`,
    a decode loop's `decode_step_programs`. Returns -1 when `obj` has
    none — callers report that as "counter unavailable" rather than a
    fake 0."""
    for name in _COUNTERS:
        fn = getattr(obj, name, None)
        if callable(fn):
            return int(fn())
    return -1
