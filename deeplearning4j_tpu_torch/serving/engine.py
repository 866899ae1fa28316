"""InferenceEngine: a bucket-padded forward for serving — the counterpart
of the JAX package's `serving/engine.py`.

An engine owns ONE apply function and the bucket ladder for its model;
every request pads up to the smallest bucket that holds it and slices
the padding back off the result. The forward is per-row independent (no
cross-example reductions at inference), so padded rows never touch real
outputs. On the card the bucket ladder bounds the shapes the forward
meets, so the caching allocator and cuBLAS see a few shapes, as the JAX
package's jit sees a few programs: `program_cache_size()` counts the
distinct bucket shapes run (its analogue of `jit_cache_size`). With a
program store active (`compilecache`) the forward goes through
`bind_program` under the engine's `cache_key`, so each bucket shape is a
store signature; `plan_fragment()` records the buckets and
`warmup_from_plan()` runs them again on a fresh engine before
`/readyz`.

Constructors: `for_network` (a MultiLayerNetwork's output layer),
`for_lstm` (an LSTM layer's per-timestep outputs), `for_transformer`
(full logits; `generate()` through the contiguous KV cache, and with
`decode_slots > 0` the continuous-batching `DecodeLoop` over K1 and K4).

Observability (`EngineStats`): requests, rows, padded rows, p50/p99
wall latency (each timed window ends with the copy of the result to the
host), per-bucket forward counts — all registry series
(`dl4j_serve_*{engine=...}`), so `/metrics`, `/stats` and this object
read the same numbers. Hot reload (`load_params`) validates leaf by leaf
and swaps by one reference assignment.

Entry points run on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device, telemetry
from deeplearning4j_tpu_torch.datasets.device_feed import (DEFAULT_MIN_BUCKET,
                                                           bucket_for,
                                                           pow2_buckets)
from deeplearning4j_tpu_torch.telemetry.trace import span
from deeplearning4j_tpu_torch.utils.digest import config_digest
from deeplearning4j_tpu_torch.weights import tree_map

__all__ = ["EngineStats", "InferenceEngine"]

_engine_seq = itertools.count()
#: constructor arguments of the engine (the rest of `for_transformer`'s
#: keywords go to the decode loop)
_ENGINE_KW = ("max_batch_size", "buckets", "min_bucket", "device",
              "cache_key")


class EngineStats:
    """Per-engine serving stats as a view over the telemetry registry:
    each engine owns a labeled set of `dl4j_serve_*{engine=...}` series
    and this object is their typed accessor. Latency percentiles come
    from the histogram's bounded reservoir; each timed window ends with
    the copy of the result to the host. `telemetry.set_enabled(False)`
    blanks recording here too — the registry is the storage."""

    def __init__(self, window: int = 2048, label: Optional[str] = None,
                 registry=None):
        reg = registry if registry is not None else telemetry.get_registry()
        self.label = label if label is not None else f"e{next(_engine_seq)}"
        lab = {"engine": self.label}
        self._requests = reg.counter(
            "dl4j_serve_requests", "inference requests served").labels(**lab)
        self._rows = reg.counter(
            "dl4j_serve_rows", "real request rows served").labels(**lab)
        self._padded = reg.counter(
            "dl4j_serve_padded_rows",
            "bucket-padding rows shipped alongside real rows").labels(**lab)
        self._errors = reg.counter(
            "dl4j_serve_errors", "failed inference requests").labels(**lab)
        self._latency = reg.histogram(
            "dl4j_serve_latency_seconds",
            "per-request wall latency incl. the result D2H read",
            window=window).labels(**lab)
        self._bucket_fam = reg.counter(
            "dl4j_serve_bucket_forwards",
            "compiled-bucket forwards by bucket size")
        self._bucket_children: dict = {}

    @property
    def requests(self) -> int:
        return int(self._requests.value)

    @property
    def rows(self) -> int:
        return int(self._rows.value)

    @property
    def padded_rows(self) -> int:
        return int(self._padded.value)

    @property
    def errors(self) -> int:
        return int(self._errors.value)

    def record(self, rows: int, bucket: int, seconds: float) -> None:
        self._requests.inc()
        self._rows.inc(rows)
        self._padded.inc(bucket - rows)
        self._latency.observe(seconds)
        child = self._bucket_children.get(bucket)
        if child is None:  # benign race: labels() is get-or-create
            child = self._bucket_fam.labels(engine=self.label,
                                            bucket=str(bucket))
            self._bucket_children[bucket] = child
        child.inc()

    def record_error(self) -> None:
        self._errors.inc()

    def bucket_forwards(self) -> dict:
        """{bucket_size: forward_count} for this engine."""
        out = {}
        for labels, child in self._bucket_fam.children():
            if labels.get("engine") == self.label:
                out[int(labels["bucket"])] = int(child.value)
        return out

    def snapshot(self) -> dict:
        rows, padded = self.rows, self.padded_rows
        shipped = rows + padded
        return {
            "requests": self.requests,
            "rows": rows,
            "padded_rows": padded,
            "errors": self.errors,
            # fraction of shipped rows that were real work
            "occupancy": (rows / shipped) if shipped else 0.0,
            "latency_p50_ms": round(self._latency.percentile(0.50) * 1e3, 3),
            "latency_p99_ms": round(self._latency.percentile(0.99) * 1e3, 3),
            "bucket_forwards": self.bucket_forwards(),
        }


class InferenceEngine:
    """A bucket-padded forward for one model on one device.

    `apply_fn(params, x)` must be a pure per-row forward over a tensor on
    the engine's device; `x`'s leading dim is the batch. Construct via
    the classmethods for the stock model families, or directly for
    anything functional. `device=None` is the CUDA device (raising
    without one)."""

    def __init__(self, apply_fn: Callable, params, *,
                 max_batch_size: int = 64,
                 buckets: Optional[Sequence[int]] = None,
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 device=None,
                 generate_fn: Optional[Callable] = None,
                 cache_key: Optional[str] = None):
        if buckets is None:
            buckets = pow2_buckets(max_batch_size, min_bucket=min_bucket)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive, got {buckets}")
        self.max_batch_size = int(max_batch_size)
        self.device = default_device(device)
        self._params = _to_device(params, self.device)
        self._apply = apply_fn
        #: model identity + device: the program store key of the forward
        self.cache_key = (f"{cache_key}|dev={self.device}"
                          if cache_key is not None else None)
        from deeplearning4j_tpu_torch import compilecache
        #: the bucketed forward's store dispatcher with a cache active,
        #: else None (`_forward` calls `_run_forward` itself)
        self._jit = compilecache.bind_program(self._run_forward,
                                              self.cache_key)
        self._generate_fn = generate_fn
        #: continuous-batching slot scheduler (transformer engines;
        #: start_decode_loop) — None until started
        self.decode_loop = None
        self._tf_cfg = None
        #: True once warmup() ran every bucket — the readiness surface
        self.warmed_up = False
        #: wall seconds the last warmup() took
        self.warmup_seconds: Optional[float] = None
        #: (batch, feature shape, dtype) of every forward run: the
        #: analogue of the JAX engine's compiled-program count
        self._shapes: set = set()
        #: feature shape + dtype the engine warms with, captured from
        #: warmup() or the first infer() — what plan_fragment() records
        self._warm_shape: Optional[tuple] = None
        #: checkpoint identity this engine serves ({path, step} or None)
        self.checkpoint: Optional[dict] = None
        #: identity of the hot-loaded draft model's checkpoint
        self.draft_checkpoint: Optional[dict] = None
        self.stats = EngineStats()
        from deeplearning4j_tpu_torch.telemetry import device as _tdev
        _tdev.watch_jit_cache("serving_engine", self.program_cache_size)

    # ----------------------------------------------------- constructors
    @classmethod
    def for_network(cls, net, **kw) -> "InferenceEngine":
        """Wrap a MultiLayerNetwork: apply = output-layer activations
        (the bucketed twin of `net.output`), at the engine's params (the
        network's table, copied to the engine's device)."""
        kw.setdefault("cache_key",
                      "serve.net:" + config_digest(net.to_json()))
        kw.setdefault("device", net.device)

        def apply(p, x):
            # a request of the wrong feature width is the caller's error
            # (ValueError, a 400 on the HTTP surface)
            net._validate(x, context="infer")
            return net.feed_forward_fn(p, x)[-1]

        return cls(apply, net.param_table, **kw)

    @classmethod
    def for_transformer(cls, params, cfg, *, decode_slots: int = 0,
                        page_size: int = 16,
                        kv_pages: Optional[int] = None,
                        max_waiting: Optional[int] = None,
                        prefix_cache: bool = True,
                        decode_kernel: str = "auto",
                        horizon: int = 1,
                        speculation: int = 0,
                        drafter: str = "ngram",
                        draft_params=None, draft_cfg=None,
                        draft_window: int = 32,
                        batch_share: float = 0.5,
                        batch_max_waiting: Optional[int] = None,
                        **kw) -> "InferenceEngine":
        """Wrap a transformer LM: apply = full logits (B, T, vocab);
        `generate()` runs the per-request contiguous KV cache.
        `decode_slots > 0` also starts the `DecodeLoop`, sized by
        `page_size`/`kv_pages`, its admission queue bounded by
        `max_waiting`, its decode attention read chosen by
        `decode_kernel` ("auto" = the paged kernel on a CUDA device,
        which raises for a config outside the kernel's envelope; the
        plain dense gather on the CPU). `prefix_cache=False` turns off
        cross-request KV prefix sharing; `horizon > 1` chains K decode
        steps a dispatch; `speculation = k > 0` instead turns on
        draft-and-verify with `drafter`; `batch_share`/`batch_max_waiting`
        tune the batch SLO tier. Of `kw`, the engine's own arguments
        (`device`, `max_batch_size`, `buckets`, `min_bucket`,
        `cache_key`) go to the constructor and the rest (`fleet_kv`,
        `role`, `kv_ship_timeout`, `start`, `name`, ...) to the loop."""
        from deeplearning4j_tpu_torch.models.transformer import \
            transformer_logits
        from deeplearning4j_tpu_torch.serving.kv_cache import \
            generate_cached

        engine_kw = {k: kw.pop(k) for k in _ENGINE_KW if k in kw}
        engine_kw.setdefault("cache_key", "serve.tf:" + config_digest(cfg))
        eng = cls(lambda p, tok: transformer_logits(p, tok, cfg), params,
                  generate_fn=lambda p, prompt, n: generate_cached(
                      p, prompt, cfg, n),
                  **engine_kw)
        eng._tf_cfg = cfg
        if decode_slots:
            eng.start_decode_loop(slots=decode_slots, page_size=page_size,
                                  n_pages=kv_pages, horizon=horizon,
                                  max_waiting=max_waiting,
                                  prefix_cache=prefix_cache,
                                  kernel=decode_kernel,
                                  speculation=speculation, drafter=drafter,
                                  draft_params=draft_params,
                                  draft_cfg=draft_cfg,
                                  draft_window=draft_window,
                                  batch_share=batch_share,
                                  batch_max_waiting=batch_max_waiting,
                                  **kw)
        elif kw:
            raise TypeError(f"unexpected keywords {sorted(kw)} (decode "
                            f"loop options need decode_slots > 0)")
        return eng

    @classmethod
    def for_lstm(cls, layer, params, **kw) -> "InferenceEngine":
        """Wrap an LSTM layer: apply = per-timestep decoded outputs over
        (B, T, n_in) input."""
        return cls(lambda p, x: layer.activate(p, x), params, **kw)

    # ------------------------------------------------------------ serve
    def _forward(self, x: np.ndarray) -> np.ndarray:
        """One bucket-shaped forward, its result copied to the host."""
        self._shapes.add((int(x.shape[0]), tuple(x.shape[1:]), x.dtype.str))
        xb = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        run = self._run_forward if self._jit is None else self._jit
        return run(xb).float().cpu().numpy()

    def _run_forward(self, xb: torch.Tensor) -> torch.Tensor:
        """The forward at the engine's current params (their shapes are
        fixed by the model, so a program's signature is the batch's)."""
        with torch.no_grad():
            return self._apply(self._params, xb)

    def infer(self, x) -> np.ndarray:
        """One request: (n, ...) -> np.ndarray of the first n output
        rows. Pads n up to the bucket ladder (requests beyond the top
        bucket take the pow2 escape ladder, still bounding the shapes),
        runs the forward, slices the padding off. The copy of the result
        to the host is inside the latency window."""
        x = np.asarray(x)
        if x.ndim < 2:
            raise ValueError(
                f"infer expects a (n, ...) batch, got shape {x.shape}")
        n = int(x.shape[0])
        if n == 0:
            raise ValueError("empty request")
        if self._warm_shape is None:
            self._warm_shape = (tuple(int(d) for d in x.shape[1:]),
                                x.dtype.str)
        start = time.perf_counter()
        try:
            with span("engine_infer", rows=n):
                b = bucket_for(n, self.buckets)
                if b != n:  # pad on the host — one copy to the device
                    x = np.concatenate(
                        [x, np.zeros((b - n, *x.shape[1:]), x.dtype)])
                out = self._forward(x)[:n]
        except Exception:
            self.stats.record_error()
            raise
        self.stats.record(n, b, time.perf_counter() - start)
        return out

    def generate(self, prompt, n_tokens: int) -> np.ndarray:
        """KV-cached greedy decode (transformer engines only): prompt
        (B, T0) int tokens -> (B, T0 + n_tokens) numpy int32."""
        if self._generate_fn is None:
            raise ValueError(
                "this engine has no generate path (construct it with "
                "InferenceEngine.for_transformer)")
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int32)
        if prompt.dim() != 2:
            raise ValueError(
                f"prompt must be (B, T0) tokens, got shape "
                f"{tuple(prompt.shape)}")
        start = time.perf_counter()
        try:
            out = self._generate_fn(self._params, prompt.to(self.device),
                                    int(n_tokens)).cpu().numpy()
        except Exception:
            self.stats.record_error()
            raise
        self.stats.record(int(prompt.shape[0]), int(prompt.shape[0]),
                          time.perf_counter() - start)
        return out

    # ------------------------------------------- continuous batching
    def start_decode_loop(self, slots: int = 8, page_size: int = 16,
                          n_pages: Optional[int] = None,
                          horizon: int = 1,
                          max_waiting: Optional[int] = None,
                          prefix_cache: bool = True,
                          fleet_kv: str = "on",
                          kv_ship_timeout: float = 2.0,
                          kernel: str = "auto",
                          speculation: int = 0,
                          drafter: str = "ngram",
                          draft_params=None, draft_cfg=None,
                          draft_window: int = 32,
                          batch_share: float = 0.5,
                          batch_max_waiting: Optional[int] = None,
                          role: str = "unified",
                          **loop_options):
        """Start the continuous-batching slot scheduler over a paged KV
        pool on this engine's device, with the JAX engine's options and
        defaults; `loop_options` (`start`, `name`, `ngram`) go to
        `DecodeLoop` as they are."""
        from deeplearning4j_tpu_torch.serving.decode_loop import DecodeLoop

        if self._tf_cfg is None:
            raise ValueError(
                "decode loop needs a transformer engine (construct it "
                "with InferenceEngine.for_transformer)")
        if self.decode_loop is not None:
            raise RuntimeError("decode loop already started")
        self.decode_loop = DecodeLoop(
            self._params, self._tf_cfg, slots=slots, page_size=page_size,
            n_pages=n_pages, horizon=horizon, max_waiting=max_waiting,
            prefix_cache=prefix_cache, fleet_kv=fleet_kv,
            kv_ship_timeout=kv_ship_timeout, kernel=kernel,
            speculation=speculation, drafter=drafter,
            draft_params=draft_params, draft_cfg=draft_cfg,
            draft_window=draft_window, batch_share=batch_share,
            batch_max_waiting=batch_max_waiting, role=role,
            device=self.device, **loop_options)
        return self.decode_loop

    def generate_stream(self, prompt, max_tokens: int,
                        eos_id: Optional[int] = None,
                        speculation: bool = True):
        """Submit one prompt (1-D token sequence) to the slot scheduler;
        returns a `GenerationStream`. `speculation=False` opts this
        request out of speculative drafting."""
        if self.decode_loop is None:
            raise ValueError(
                "this engine has no decode loop (pass decode_slots= to "
                "for_transformer or call start_decode_loop)")
        return self.decode_loop.submit(prompt, max_tokens, eos_id,
                                       speculation=speculation)

    def close(self) -> None:
        """Drain and stop the decode loop (no-op without one)."""
        if self.decode_loop is not None:
            self.decode_loop.close()

    # ------------------------------------------------------- hot reload
    def load_params(self, params, *,
                    checkpoint: Optional[dict] = None) -> None:
        """Swap this engine's weights — zero-downtime reload. The new
        tree is validated leaf for leaf (structure, shapes and dtypes,
        the error naming the first mismatched leaf) and copied onto the
        engine's device BEFORE the swap, so the visible transition is
        one reference assignment: a forward in flight keeps the params
        it read, later ones see the new. `checkpoint` ({path, step})
        becomes visible only after the swap."""
        from deeplearning4j_tpu_torch.checkpoint.restore import \
            validate_like

        validate_like(params, self._params, context="engine reload")
        params = _to_device(params, self.device)
        self._params = params  # atomic swap
        if self.decode_loop is not None:
            # the loop's captured graphs read its params' storage: it
            # copies the new weights in place between dispatches
            self.decode_loop.load_params(params)
        self.checkpoint = dict(checkpoint) if checkpoint else None

    def load_draft_params(self, params, *,
                          checkpoint: Optional[dict] = None) -> None:
        """Swap the speculative DRAFT model's weights (the `/reload
        {"target": "draft"}` path). Requires a decode loop running a
        model drafter; same validation as `load_params`. A bad draft
        model can only cost acceptance, never correctness."""
        from deeplearning4j_tpu_torch.checkpoint.restore import \
            validate_like

        drafter = (None if self.decode_loop is None
                   else self.decode_loop._drafter)
        if drafter is None or drafter.kind != "model":
            raise ValueError(
                "no draft model to reload: the decode loop must be "
                "running with speculation > 0 and drafter='model'")
        validate_like(params, drafter.params, context="draft reload")
        drafter.load_params(params)
        self.draft_checkpoint = dict(checkpoint) if checkpoint else None

    # ---------------------------------------------------- observability
    def warmup(self, feature_shape: Sequence[int],
               dtype=np.float32) -> None:
        """Run every bucket's forward once up front (the JAX engine's
        execute-every-bucket warmup), so the first real requests find
        the allocator and cuBLAS warm. `feature_shape` is one example's
        shape (without the batch dim). Bypasses EngineStats. With a
        program store active each bucket is a store lookup too."""
        self._warm_buckets(self.buckets, feature_shape, dtype)

    def _warm_buckets(self, buckets, feature_shape, dtype) -> None:
        start = time.perf_counter()
        for b in buckets:
            self._forward(np.zeros((int(b), *feature_shape), dtype))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.warmup_seconds = time.perf_counter() - start
        self._warm_shape = (tuple(int(d) for d in feature_shape),
                            np.dtype(dtype).str)
        self.warmed_up = True

    # ------------------------------------------------- warmup plans
    def plan_fragment(self) -> Optional[dict]:
        """The "engine" fragment of a warmup plan (the JAX package's
        format): the buckets this engine ran — ladder plus any pow2
        escape buckets traffic actually forwarded — and the feature
        shape to run them with. None until a shape is known (no warmup
        and no traffic yet) or when the engine has no cache identity."""
        if self.cache_key is None or self._warm_shape is None:
            return None
        shape, dtype = self._warm_shape
        buckets = set(self.buckets) | set(self.stats.bucket_forwards())
        return {"cache_key": self.cache_key,
                "buckets": sorted(int(b) for b in buckets),
                "feature_shape": list(shape),
                "dtype": dtype}

    def warmup_from_plan(self, frag: dict) -> None:
        """Replay a recorded plan fragment: run every bucket it lists
        (each a store hit on a warm cache), escape buckets included, so
        traffic then meets no new shape. A fragment recorded for a
        different model identity falls back to the standard ladder
        warmup at its feature shape."""
        shape = tuple(int(d) for d in frag.get("feature_shape", ()))
        dtype = np.dtype(frag.get("dtype", "float32"))
        if frag.get("cache_key") != self.cache_key:
            self.warmup(shape, dtype)
            return
        self._warm_buckets(frag.get("buckets", self.buckets), shape, dtype)

    def program_cache_size(self) -> int:
        """Distinct bucket shapes the forward has run — the analogue of
        the JAX engine's compiled-program count: with bucket padding it
        stays <= len(buckets) hit (+ escape buckets)."""
        return len(self._shapes)

    def snapshot(self) -> dict:
        snap = self.stats.snapshot()
        snap["buckets"] = list(self.buckets)
        snap["compiled_programs"] = self.program_cache_size()
        if self.warmup_seconds is not None:
            snap["warmup_seconds"] = round(self.warmup_seconds, 4)
        snap["checkpoint"] = self.checkpoint
        if self.draft_checkpoint is not None:
            snap["draft_checkpoint"] = self.draft_checkpoint
        snap["device"] = str(self.device)
        if self.decode_loop is not None:
            snap["decode"] = self.decode_loop.snapshot()
        return snap


def _to_device(params, device):
    """The tree with every leaf a detached tensor on `device` (numpy
    arrays taken as they are)."""
    return tree_map(lambda v: torch.as_tensor(v).detach().to(device),
                    params)
