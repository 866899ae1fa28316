"""Multi-replica dispatch: one engine per local device, least-loaded.

A single engine serializes on its device. For a host with several CUDA
devices, `ReplicaSet` clones the params onto each device as an
independent `InferenceEngine` and dispatches requests across them, and a
shared `MicroBatcher` can sit in front so coalesced batches fan out over
the cards. `for_network` builds one engine per CUDA device (one on a
one-card host) and a single engine for a network on the CPU; tests
build sets of explicit engines.

Dispatch policy: **least outstanding requests**, with round-robin as
the tiebreak. Blind round-robin behind a coalescing batcher is fine
when every forward costs the same, but ragged buckets don't — a replica
stuck on a top-bucket forward keeps receiving work it can't start. The
set tracks per-engine in-flight counts under ONE lock; `infer`,
`generate`, and `generate_stream` all select through the same locked
helper (the decode-loop cursor shares the lock discipline rather than
keeping its own), so the idle-replica-first property holds across both
traffic classes. On a uniform idle stream the tiebreak degenerates to
exact round-robin — the historical behavior, still pinned by tests.

This is intra-host scale-out; cross-host serving stacks the fleet
router (`serving/fleet.py`, docs/FLEET.md) on top — each host runs its
own replica set behind one `serve_network` endpoint.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import List, Optional, Sequence

from deeplearning4j_tpu_torch.serving.batcher import MicroBatcher
from deeplearning4j_tpu_torch.serving.engine import InferenceEngine

__all__ = ["ReplicaSet"]


class ReplicaSet:
    def __init__(self, engines: Sequence[InferenceEngine]):
        if not engines:
            raise ValueError("ReplicaSet needs at least one engine")
        self.engines: List[InferenceEngine] = list(engines)
        self._lock = threading.Lock()
        self._rr = 0  # tiebreak cursor, shared by ALL dispatch paths
        self._outstanding = [0] * len(self.engines)

    @classmethod
    def for_network(cls, net, n_replicas: Optional[int] = None,
                    devices=None, **engine_kw) -> "ReplicaSet":
        """One engine per CUDA device (params copied to each) for a
        network on the card, a single engine for a network on the CPU;
        `n_replicas` caps how many devices are used."""
        import torch

        if devices is None:
            if net.device.type == "cuda":
                devices = [torch.device("cuda", i)
                           for i in range(torch.cuda.device_count())]
            else:
                devices = [net.device]
        if n_replicas is not None:
            if n_replicas < 1:
                raise ValueError(
                    f"n_replicas must be >= 1, got {n_replicas}")
            devices = devices[:n_replicas]
        return cls([InferenceEngine.for_network(net, device=d, **engine_kw)
                    for d in devices])

    # --------------------------------------------------------- selection
    def _select(self, eligible: Sequence[int], load_of=None,
                acquire: bool = False) -> int:
        """Pick the least-loaded eligible engine index (round-robin
        tiebreak) and advance the shared cursor. Caller holds no lock;
        this takes the set's one lock — the single dispatch discipline
        for every traffic class. `load_of(i)` overrides the load metric
        (the decode path keys on live loop pressure instead of the
        per-call outstanding counter). `acquire=True` also increments
        the winner's outstanding count INSIDE the same critical
        section — select-then-increment under two lock grabs would let
        two concurrent requests pick the same idle engine."""
        if load_of is None:
            load_of = lambda i: self._outstanding[i]  # noqa: E731
        n = len(self.engines)
        with self._lock:
            best = min(eligible,
                       key=lambda i: (load_of(i), (i - self._rr) % n))
            self._rr = (best + 1) % n
            if acquire:
                self._outstanding[best] += 1
            return best

    @contextmanager
    def _checkout(self):
        """Select an engine for one short request, holding its
        outstanding slot for the call's duration."""
        idx = self._select(range(len(self.engines)), acquire=True)
        try:
            yield self.engines[idx]
        finally:
            with self._lock:
                self._outstanding[idx] -= 1

    # --------------------------------------------------------- dispatch
    def infer(self, x):
        with self._checkout() as engine:
            return engine.infer(x)

    def generate(self, prompt, n_tokens: int):
        """Per-request compiled-scan decode on the least-loaded replica
        (the legacy path; concurrent generate traffic belongs on
        `generate_stream` — the slot scheduler is its own batcher)."""
        with self._checkout() as engine:
            return engine.generate(prompt, n_tokens)

    def generate_stream(self, prompt, max_tokens: int, eos_id=None,
                        speculation: bool = True):
        """Submit one prompt to a replica's continuous-batching decode
        loop: least loop pressure (queued + occupied slots) wins, with
        the same shared round-robin cursor as `infer` breaking ties —
        so concurrent generate traffic fans across chips toward the
        idlest loop, without coalescing delays. `speculation=False`
        opts the request out of speculative drafting on loops that
        have it on (bit-identical output either way)."""
        loops = [i for i, e in enumerate(self.engines)
                 if e.decode_loop is not None]
        if not loops:
            raise ValueError(
                "no replica runs a decode loop (construct engines "
                "with decode_slots= or call start_decode_loop)")
        idx = self._select(
            loops, load_of=lambda i: self.engines[i].decode_loop.load)
        return self.engines[idx].generate_stream(prompt, max_tokens,
                                                 eos_id,
                                                 speculation=speculation)

    def warmup(self, feature_shape, **kw) -> None:
        for engine in self.engines:
            engine.warmup(feature_shape, **kw)

    def batcher(self, **kw) -> MicroBatcher:
        """A shared micro-batcher whose coalesced batches fan out over
        the replicas (least-outstanding first)."""
        return MicroBatcher(self.infer, **kw)

    # --------------------------------------------------------- hot reload
    def load_params(self, params, *, checkpoint=None) -> None:
        """Swap every replica's weights (each engine validates shapes
        and swaps atomically — in-flight requests finish on the old
        params; see InferenceEngine.load_params). `checkpoint` records
        the served identity ({path, step}) on every engine."""
        for engine in self.engines:
            engine.load_params(params, checkpoint=checkpoint)

    def load_checkpoint(self, path: str, step: Optional[int] = None) -> dict:
        """Hot-reload all replicas from a checkpoint — a sharded
        directory (the sharded checkpoint format) or a legacy single-file
        npz — without dropping in-flight requests. The checkpoint's
        params tree must match the serving model's architecture (the
        per-leaf validation errors name the first mismatched leaf).
        Returns the checkpoint's info dict (step/cursor/metadata)."""
        import os

        device = self.engines[0].device
        if os.path.isdir(path):
            from deeplearning4j_tpu_torch.checkpoint.restore import \
                restore_network

            net, info = restore_network(path, step, device=device)
        else:
            if step is not None:
                # a single-file checkpoint holds exactly one state —
                # silently serving it against an explicit step pin would
                # defeat a rollback-to-step intent
                raise ValueError(
                    f"step={step} was requested but {path!r} is a "
                    "single-file checkpoint with no steps; point at a "
                    "sharded checkpoint directory to pin a step")
            from deeplearning4j_tpu_torch.scaleout.checkpoint import \
                load_checkpoint

            net, info = load_checkpoint(path, device=device)
        self.load_params(net.param_table,
                         checkpoint={"path": os.path.abspath(path),
                                     "step": info.get("step", step)})
        return info

    def load_draft_params(self, params, *, checkpoint=None) -> None:
        """Swap the speculative draft model's weights on every replica
        whose decode loop runs a model drafter (the `/reload`
        `{"target": "draft"}` canary path). Raises when NO replica has
        a draft model — a canary that silently reloaded nothing must
        not report success."""
        loaded = 0
        for engine in self.engines:
            loop = engine.decode_loop
            if (loop is not None and loop._drafter is not None
                    and loop._drafter.kind == "model"):
                engine.load_draft_params(params, checkpoint=checkpoint)
                loaded += 1
        if not loaded:
            raise ValueError(
                "no replica runs a model drafter (serve with "
                "speculation > 0 and drafter='model')")

    # ---------------------------------------------------- observability
    @property
    def checkpoint(self):
        """Checkpoint identity the set serves ({path, step} or None) —
        every engine gets the same identity through load_params, so the
        first engine speaks for the set."""
        return self.engines[0].checkpoint

    def program_cache_size(self) -> int:
        sizes = [e.program_cache_size() for e in self.engines]
        return -1 if any(s < 0 for s in sizes) else sum(sizes)

    def outstanding(self) -> List[int]:
        """Per-engine in-flight request counts (a point-in-time copy)."""
        with self._lock:
            return list(self._outstanding)

    def snapshot(self) -> dict:
        reps = [e.snapshot() for e in self.engines]
        buckets: dict = {}
        for r in reps:
            for b, c in r.get("bucket_forwards", {}).items():
                buckets[b] = buckets.get(b, 0) + c
        return {
            "replicas": len(self.engines),
            "checkpoint": self.checkpoint,
            "requests": sum(r["requests"] for r in reps),
            "rows": sum(r["rows"] for r in reps),
            "errors": sum(r["errors"] for r in reps),
            "outstanding": self.outstanding(),
            "compiled_programs": self.program_cache_size(),
            # aggregated per-bucket forward counts across replicas
            "bucket_forwards": {str(b): buckets[b]
                                for b in sorted(buckets)},
            "per_replica": reps,
        }
