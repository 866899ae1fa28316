"""Warmup plans: record the program set a replica used; replay it at
boot — the counterpart of the JAX package's `compilecache/warmup.py`,
in the JAX package's file format.

A warmup plan is a small JSON document describing every program a
serving process needed — predict buckets, decode prefill/prefill-ctx
bucket pairs, the decode step (its CUDA graph on the card), speculative
verify widths, the draft rollout — in LOGICAL terms (bucket sizes,
shapes). The signatures live in the `ProgramStore`; the plan is the
table of contents that tells a fresh process WHICH programs its warm
hooks run (the bucket forwards, the prefill groups) or capture (the
decode step and verify graphs) before opening `/readyz`, so a
warm-cache replica has its whole working set ready and then serves with
`recompiled_after_warmup == 0`.

Plans are written with the same crash-atomic idiom as cache entries
and carry the runtime fingerprint: a plan recorded under a different
torch/CUDA/device/kernel build is ignored (the cache it points at was
quarantined anyway). `serve_network(..., warmup_plan="auto")` resolves the plan
path inside the cache dir from the engine's cache key, so record and
replay need no coordination beyond sharing the cache directory.

Format (the JAX package's docs/WARMUP.md has the field-by-field
reference):

    {"version": 1, "fingerprint": "<runtime>",
     "engines": [{"cache_key": ..., "buckets": [...],
                  "feature_shape": [...], "dtype": "<f4"}, ...],
     "decode": {"cache_key": ..., "step": true, "verify": true,
                "copy": false,
                "prefill": [[bb, tb], ...],
                "prefill_ctx": [[bb, cb, tb], ...],
                "draft": {"rows": n, "k": k}} | null}

The engine/decode flags record what the source replica actually USED
(e.g. "copy" is true only if a prefix-cache fork really dispatched the
copy program), so a replayed process loads exactly the recorded
program set — the round-trip invariant the tests pin is that record →
replay yields identical store key sets.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional

from deeplearning4j_tpu_torch.compilecache.store import (
    key_digest, runtime_fingerprint)

__all__ = ["save_plan", "load_plan", "auto_plan_path", "replay_plan",
           "PLAN_VERSION"]

log = logging.getLogger(__name__)

PLAN_VERSION = 1


def auto_plan_path(cache_root: str, cache_key: str,
                   role: Optional[str] = None) -> str:
    """Where `warmup_plan="auto"` records/finds the plan for an engine
    identity: co-located in the cache dir, keyed like the programs.

    `role` scopes the plan to a disaggregated replica role: a prefill
    replica's plan
    records only the prefill lanes and a decode replica's only the
    decode ladder, so neither warms the other's programs. The
    unified/None role keeps the legacy digest — existing plans stay
    valid across the upgrade."""
    key = cache_key
    if role and role != "unified":
        key = f"{cache_key}|role={role}"
    return os.path.join(os.path.abspath(cache_root), "plans",
                        key_digest(key) + ".json")


def save_plan(path: str, plan: Dict[str, Any]) -> bool:
    """Atomic write (tmp -> fsync -> rename); stamps version and
    fingerprint. Returns False instead of raising — a failed plan
    write costs the next boot a cold compile, nothing more."""
    doc = dict(plan)
    doc.setdefault("version", PLAN_VERSION)
    doc.setdefault("fingerprint", runtime_fingerprint())
    tmp = path + ".tmp"
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return True
    except OSError as e:
        log.warning("warmup plan write %s failed: %s", path, e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def load_plan(path: str) -> Optional[Dict[str, Any]]:
    """The plan at `path`, or None for missing/torn/wrong-version/
    wrong-fingerprint — every one of which means "warm up the usual
    way" (the plan is an accelerant, never a requirement)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        log.warning("warmup plan %s unreadable (%s) — ignoring", path, e)
        return None
    if not isinstance(doc, dict) or doc.get("version") != PLAN_VERSION:
        log.warning("warmup plan %s has unsupported version %r — "
                    "ignoring", path, doc.get("version")
                    if isinstance(doc, dict) else None)
        return None
    fp = runtime_fingerprint()
    if doc.get("fingerprint") != fp:
        log.info("warmup plan %s recorded under fingerprint %s, "
                 "runtime is %s — ignoring", path,
                 doc.get("fingerprint"), fp)
        return None
    return doc


def replay_plan(plan: Dict[str, Any], *, engines=(), loops=()) -> dict:
    """Drive each engine/decode-loop's own warm hooks from the plan's
    fragments (duck-typed: `warmup_from_plan` / `warm_programs`).
    Per-object failures degrade to that object's normal cold warmup;
    the report says what happened."""
    report = {"engines": 0, "loops": 0, "errors": 0}
    frags = {f.get("cache_key"): f
             for f in plan.get("engines") or [] if f}
    for eng in engines:
        frag = frags.get(getattr(eng, "cache_key", None))
        if frag is None:
            continue
        try:
            eng.warmup_from_plan(frag)
            report["engines"] += 1
        except Exception as e:
            report["errors"] += 1
            log.warning("plan replay failed on engine (%s: %s) — "
                        "falling back to standard warmup",
                        type(e).__name__, e)
    dfrag = plan.get("decode")
    if dfrag:
        for loop in loops:
            try:
                loop.warm_programs(dfrag)
                report["loops"] += 1
            except Exception as e:
                report["errors"] += 1
                log.warning("plan replay failed on decode loop "
                            "(%s: %s) — programs will compile on "
                            "first use", type(e).__name__, e)
    return report
