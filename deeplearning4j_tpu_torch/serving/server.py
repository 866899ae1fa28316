"""Thin stdlib HTTP JSON front end over engines/replicas/batcher — the
counterpart of the JAX package's `serving/server.py`, with the same
routes, bodies and replies.

ThreadingHTTPServer on a daemon thread (utils/httpd.py), port-0
auto-assign, graceful close. Endpoints:

- ``POST /predict``  {"inputs": [[...], ...]} ->
  {"outputs": [[...]...], "classes": [...]} — rows go through the
  shared micro-batcher (coalescing concurrent clients) onto the
  round-robin replica set.
- ``POST /generate`` {"prompt": [[...tokens]], "max_tokens": N,
  "eos_id": E?, "stream": bool?} -> {"tokens": [[...]],
  "finish_reasons": [...]} — continuous-batching decode: each prompt
  row joins the slot scheduler (serving/decode_loop.py) and terminates
  independently on EOS or its own max_tokens ("n_tokens" is accepted as
  a legacy alias; the non-streaming response shape is unchanged).
  ``"stream": true`` switches the response to chunked transfer with one
  NDJSON line per emitted token ({"row": r, "token": t,
  "token_index": i} — `token_index` is the token's absolute per-row
  position, the fleet router's failover dedupe key) and a final
  {"done": true, ...} summary line — clients see tokens as slots emit
  them. `max_tokens` and `token_index_base` accept a per-row list
  (failover continuations). Requires a transformer engine; 404
  otherwise.
- ``POST /reload``   {"path": "<checkpoint dir or .ckpt>", "step": N?}
  — hot-swap every replica's weights from a checkpoint
  (docs/CHECKPOINTS.md) WITHOUT dropping in-flight requests: each
  engine validates shapes, stages the new params on its device, then
  swaps by a single reference assignment.
- ``GET /healthz``   liveness + replica count. Liveness ONLY — a
  process that is up but still compiling answers 200 here.
- ``GET /readyz``    readiness: 503 until the warmup precompile has
  finished (sync warmup is done before the socket opens; with
  ``warmup_async=True`` the socket opens immediately and this flips
  when the background warmup lands) and, when a decode loop runs, its
  scheduler thread is alive. The fleet router (serving/fleet.py) and
  any external LB gate admission on this, never on /healthz.
- ``GET /stats``     replica + batcher (queue depth, per-bucket forward
  counts) + uptime counters + last reload.
- ``POST /kv/export`` {"tokens": [...], "max_chunks": N?} -> the
  `DL4JKV1` page payload of the cached pages covering the tokens' head
  (serving/fleetkv.py); 404 while the plane is off.
- ``POST /prefill``  {"prompt": [...]} — a handoff's prefill leg: the
  prompt's full pages are computed into this replica's prefix trie for a
  decode replica to pull (its `/generate` names this server as
  `kv_donor`).
- ``GET /metrics``   Prometheus text exposition of the process-global
  telemetry registry (serving, decode, device series); ``GET /snapshot``
  is the JSON twin.

Overload is machine-actionable end to end: a full batcher queue
(`max_queue=`) or a saturated decode admission queue (`max_waiting=`)
answers ``503`` with a ``Retry-After`` header and
``{"error": "overloaded", "retry_after_ms": N}`` — the shape the fleet
router's shedding also speaks (serving/errors.py, docs/FLEET.md).

Warmup: `warmup_shape` runs every bucket of every predict engine once
(sync before the socket opens, or in the background with
`warmup_async=True`, `/readyz` answering 503 until it lands);
`recompiled_after_warmup` counts the programs built after it, with or
without a store: the growth of the program counts (bucket shapes run,
prefill and warm-tail prefill groups, captured decode graphs) since
warmup ended. A store hit skips no work in the port (the step still
runs), so the store's misses since warmup are reported beside it as
`store_misses_after_warmup`, never in its place. `compile_cache=DIR`
activates the program store (`compilecache/`) and `warmup_plan`
("auto": the plan in the store's directory; a path; "off") replays the
program set an earlier boot recorded — the predict buckets, the decode
loop's prefill groups, its step and verify graph captures and the draft
rollout — before `/readyz` flips; the handle records the plan after
warmup and again at close. /stats carries `compile_cache` and
`warmup.plan_replayed`, /metrics `dl4j_compile_warmup_seconds` and the
store's `dl4j_compile_cache_*` series.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.serving.engine import InferenceEngine
from deeplearning4j_tpu_torch.serving.errors import (Deadline,
                                                     DeadlineExceededError,
                                                     OverloadedError,
                                                     deadline_body,
                                                     overload_body,
                                                     parse_tier)
from deeplearning4j_tpu_torch.serving.replicas import ReplicaSet
from deeplearning4j_tpu_torch.telemetry import exposition
from deeplearning4j_tpu_torch.testing import chaos
from deeplearning4j_tpu_torch.utils.httpd import ServerHandle, start_http_server

__all__ = ["ServingHandle", "serve_network"]

_M_RELOADS = telemetry.counter(
    "dl4j_serve_reloads", "hot checkpoint reloads applied to the replicas")
_M_DEADLINE = telemetry.counter(
    "dl4j_serve_deadline_exceeded",
    "requests answered 504 because their deadline budget was spent")
_M_DISCONNECTS = telemetry.counter(
    "dl4j_serve_client_disconnects",
    "streaming clients that hung up mid-/generate (their slots were "
    "cancelled and their KV pages freed)")
_M_WARMUP_S = telemetry.gauge(
    "dl4j_compile_warmup_seconds",
    "wall seconds the serving warmup took (plan replay + bucket "
    "precompile) — the cold-vs-warm spin-up number docs/WARMUP.md "
    "tracks")

#: per-request wait on the batcher future — generous; the batcher bounds
#: queueing at max_delay_ms, so hitting this means the engine died.
#: Requests carrying a deadline derive their wait from the REMAINING
#: budget instead (docs/SERVING.md "Deadlines").
_RESULT_TIMEOUT_S = 120.0


class ServingHandle:
    """A running serving endpoint: http handle + batcher + replicas.

    Constructed (and handed to the request handler) BEFORE the socket
    opens — `http` is attached right after bind — so /stats is safe from
    the first accepted connection; stats() never touches `http`.
    """

    def __init__(self, replicas: ReplicaSet, batcher,
                 generate_engine: Optional[InferenceEngine],
                 http: Optional[ServerHandle] = None,
                 warmup_pending: bool = False,
                 role: str = "unified",
                 model_id: Optional[str] = None):
        self.http = http
        self.replicas = replicas
        self.batcher = batcher
        self.generate_engine = generate_engine
        # disaggregated-serving identity (docs/FLEET.md "Disaggregated
        # roles"): announced in /readyz so the fleet's role/model
        # registry reads placement identity off the probe that gates
        # admission — never from config drift
        self.role = role
        self.model_id = model_id
        self.started_at = time.time()
        self.last_reload: Optional[dict] = None
        # readiness state: pre-set unless an async warmup is in flight
        self._warmed = threading.Event()
        self.warmup_error: Optional[str] = None
        if not warmup_pending:
            self._warmed.set()
        # warm-start state: the plan loaded at boot (None = cold), where
        # to record this process's own program set, and the post-warmup
        # baselines that define `recompiled_after_warmup`
        self.warmup_plan: Optional[dict] = None
        self.warmup_plan_path: Optional[str] = None
        self.warmup_seconds: Optional[float] = None
        self.plan_replay: Optional[dict] = None
        self._baseline_misses: Optional[int] = None
        self._baseline_programs: Optional[int] = None

    @property
    def url(self) -> str:
        return self.http.url

    @property
    def port(self) -> int:
        return self.http.port

    def close(self) -> None:
        """Stop accepting requests, flush the batcher, drain the decode
        loop, release the socket. Re-records the warmup plan on the way
        out — it now includes every program TRAFFIC used (escape
        buckets, prefill groups), so the next boot warms the real working
        set, not just what warmup touched."""
        self.http.close()
        if self.batcher is not None:
            self.batcher.close()
        if self.generate_engine is not None:
            self.generate_engine.close()  # drains the decode loop
        self.record_plan()

    # ----------------------------------------------- warmup plans
    def build_plan(self) -> dict:
        """The warmup plan describing this process's program set: one
        fragment per predict engine (matched at replay by cache_key)
        plus the decode loop's."""
        plan: dict = {"engines": [], "decode": None}
        for eng in self.replicas.engines:
            frag = getattr(eng, "plan_fragment", lambda: None)()
            if frag is not None:
                plan["engines"].append(frag)
        ge = self.generate_engine
        if ge is not None and ge.decode_loop is not None:
            plan["decode"] = ge.decode_loop.plan_fragment()
        return plan

    def record_plan(self) -> bool:
        """Write the current program set to `warmup_plan_path`
        (crash-atomic; no-op without a path)."""
        from deeplearning4j_tpu_torch.compilecache import warmup as _warmup

        if self.warmup_plan_path is None:
            return False
        return _warmup.save_plan(self.warmup_plan_path, self.build_plan())

    def _program_total(self) -> int:
        """Every program counter this process exposes, summed: each
        engine's bucket shapes, the generate engine's, and the decode
        loop's captured graphs, prefill and warm-tail prefill groups."""
        total = 0
        for eng in self.replicas.engines:
            total += max(0, eng.program_cache_size())
        ge = self.generate_engine
        if ge is not None:
            total += max(0, ge.program_cache_size())
            loop = ge.decode_loop
            if loop is not None:
                total += (loop.decode_step_programs()
                          + loop.prefill_programs()
                          + loop.prefill_ctx_programs())
        return total

    def recompiled_after_warmup(self) -> Optional[int]:
        """Programs built AFTER warmup finished: the growth of
        `_program_total` since the post-warmup baseline, whether or not
        a store is active. None until warmup has run. Zero on a warm
        boot is the point of the warmup plan."""
        if self._baseline_programs is None:
            return None
        return max(0, self._program_total() - self._baseline_programs)

    def store_misses_after_warmup(self) -> Optional[int]:
        """The program store's misses since warmup ended (signatures met
        for the first time by any process on this store); None without
        a store or before warmup."""
        from deeplearning4j_tpu_torch import compilecache

        comp = compilecache.active_compiler()
        if comp is None or self._baseline_misses is None:
            return None
        return int(comp.store.stats()["misses"] - self._baseline_misses)

    def __enter__(self) -> "ServingHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------- readiness
    def _run_warmup(self, feature_shape) -> None:
        """Warmup (sync before the socket opens, or on a background
        thread with `warmup_async=True` — /healthz answers, /readyz
        gates admission until this lands). With a loaded warmup plan,
        each engine and the decode loop replay their recorded fragment;
        engines without a matching fragment — and every engine on a
        cold boot — run every bucket once. Afterwards the post-warmup
        baselines are pinned (recompiled_after_warmup counts from here)
        and the plan is recorded for the next boot."""
        from deeplearning4j_tpu_torch import compilecache

        start = time.perf_counter()
        try:
            plan = self.warmup_plan
            frags = {f.get("cache_key"): f
                     for f in (plan or {}).get("engines", [])}
            replayed = {"engines": 0, "decode": 0}
            for eng in self.replicas.engines:
                frag = frags.get(getattr(eng, "cache_key", None))
                if frag is not None:
                    eng.warmup_from_plan(frag)
                    replayed["engines"] += 1
                elif feature_shape is not None:
                    eng.warmup(tuple(feature_shape))
            loop = (self.generate_engine.decode_loop
                    if self.generate_engine is not None else None)
            dfrag = (plan or {}).get("decode")
            if loop is not None and dfrag:
                replayed["decode"] = loop.warm_programs(dfrag)
            if plan is not None:
                self.plan_replay = replayed
        except Exception as e:  # surface via /readyz, don't die silent
            self.warmup_error = f"{type(e).__name__}: {e}"
        finally:
            self.warmup_seconds = time.perf_counter() - start
            _M_WARMUP_S.set(self.warmup_seconds)
            comp = compilecache.active_compiler()
            if comp is not None:
                self._baseline_misses = int(comp.store.stats()["misses"])
            self._baseline_programs = self._program_total()
            self._warmed.set()
        self.record_plan()

    def readiness(self) -> dict:
        """Readiness probe payload: ready iff warmup precompile is done
        (and didn't fail) and, if a decode loop runs, its scheduler
        thread is alive. `/readyz` (and the fleet router) keys on
        this; liveness stays on /healthz."""
        reasons = []
        if not self._warmed.is_set():
            reasons.append("warmup in progress")
        elif self.warmup_error is not None:
            reasons.append(f"warmup failed: {self.warmup_error}")
        loop = (self.generate_engine.decode_loop
                if self.generate_engine is not None else None)
        if loop is not None and not loop.alive:
            reasons.append("decode loop not running")
        if self.batcher is not None and not self.batcher._worker.is_alive():
            reasons.append("batcher worker not running")
        out = {"ready": not reasons,
               "warmup_done": self._warmed.is_set(),
               "replicas": len(self.replicas.engines),
               # checkpoint identity ({path, step} or None): the fleet
               # journal and the deployment controller's convergence
               # check read WHAT this replica serves from the same
               # probe that gates admission (docs/PIPELINE.md)
               "checkpoint": self.replicas.checkpoint,
               # (role, model_id): the disaggregated fleet's placement
               # identity (docs/FLEET.md "Disaggregated roles")
               "role": self.role,
               "model_id": self.model_id}
        if loop is not None:
            out["decode_loop_alive"] = loop.alive
            # fleet KV plane: the affinity summary rides the SAME
            # probe that gates admission, so the router's placement
            # view refreshes exactly as fast as its health view. A
            # summary fault (chaos fleet.kv_summary) degrades this
            # replica to "no affinity signal" — it must never turn a
            # healthy replica unready
            try:
                summary = loop.kv_summary()
            except Exception:
                summary = None
            if summary is not None:
                out["kv_summary"] = summary
        if self.warmup_seconds is not None:
            out["warmup_seconds"] = round(self.warmup_seconds, 4)
        if reasons:
            out["reason"] = "; ".join(reasons)
        return out

    def stats(self) -> dict:
        out = {"uptime_s": round(time.time() - self.started_at, 3),
               "checkpoint": self.replicas.checkpoint,
               "role": self.role,
               "model_id": self.model_id,
               "replicas": self.replicas.snapshot()}
        if self.batcher is not None:
            out["batcher"] = self.batcher.snapshot()
        if self.generate_engine is not None:
            out["generate"] = self.generate_engine.snapshot()
        if self.last_reload is not None:
            out["last_reload"] = self.last_reload
        if self.warmup_seconds is not None:
            out["warmup"] = {
                "seconds": round(self.warmup_seconds, 4),
                "plan_replayed": self.plan_replay,
                "recompiled_after_warmup":
                    self.recompiled_after_warmup(),
                "store_misses_after_warmup":
                    self.store_misses_after_warmup(),
            }
        from deeplearning4j_tpu_torch import compilecache

        cache_stats = compilecache.stats()
        if cache_stats is not None:
            out["compile_cache"] = cache_stats
        return out

    def load_checkpoint(self, path: str, step: Optional[int] = None) -> dict:
        """Hot-swap replica weights from a checkpoint path (sharded dir
        or legacy npz) without dropping in-flight requests; records the
        reload in /stats. The HTTP `/reload` route calls this."""
        info = self.replicas.load_checkpoint(path, step=step)
        self.last_reload = {
            "path": path,
            "step": info.get("step"),
            "iterator_position": info.get("iterator_position"),
            "at": time.time(),
        }
        _M_RELOADS.inc()
        return info

    def load_draft_checkpoint(self, path: str,
                              step: Optional[int] = None) -> dict:
        """Hot-swap the speculative DRAFT model's weights from a
        checkpoint (sharded dir with a `params` payload) — the
        `/reload {"target": "draft"}` canary path. Serving weights and
        their checkpoint identity are untouched; a draft swap can only
        move acceptance rate, never output bits."""
        import os

        from deeplearning4j_tpu_torch.checkpoint.restore import \
            load_payload_tree

        if self.generate_engine is None:
            raise ValueError("no generate engine configured")
        payload, manifest = load_payload_tree(path, step)
        params = (payload["params"]
                  if isinstance(payload, dict) and "params" in payload
                  else payload)
        info = {"path": os.path.abspath(path),
                "step": manifest.get("step", step)}
        self.generate_engine.load_draft_params(params, checkpoint=info)
        self.last_reload = {
            "path": path,
            "step": info["step"],
            "target": "draft",
            "at": time.time(),
        }
        _M_RELOADS.inc()
        return info


def serve_network(net=None, *, replicas: Optional[ReplicaSet] = None,
                  generate_engine: Optional[InferenceEngine] = None,
                  n_replicas: Optional[int] = None,
                  max_batch_size: int = 64, max_delay_ms: float = 2.0,
                  max_queue: Optional[int] = None,
                  slots: int = 8, page_size: int = 16,
                  kv_pages: Optional[int] = None,
                  max_waiting: Optional[int] = None,
                  prefix_cache: bool = True,
                  fleet_kv: str = "on",
                  kv_ship_timeout: float = 2.0,
                  decode_kernel: str = "auto",
                  horizon: int = 1,
                  speculation: int = 0,
                  drafter: str = "ngram",
                  draft_params=None, draft_cfg=None,
                  draft_window: int = 32,
                  batch_share: float = 0.5,
                  role: str = "unified",
                  model_id: Optional[str] = None,
                  host: str = "127.0.0.1", port: int = 0,
                  warmup_shape=None,
                  warmup_async: bool = False,
                  checkpoint: Optional[dict] = None,
                  compile_cache: Optional[str] = None,
                  warmup_plan: Optional[str] = "auto") -> ServingHandle:
    """Serve a MultiLayerNetwork (or a prebuilt ReplicaSet) over HTTP.

    Pass `net` for the common case — a replica set is built across
    local devices (capped by `n_replicas`) with `max_batch_size` as the
    top of each engine's bucket ladder — or pass `replicas=` directly
    for custom engines. `generate_engine` (an
    InferenceEngine.for_transformer) enables /generate; its requests
    ride the continuous-batching decode loop (`slots` concurrent
    streams over a paged KV pool of `kv_pages` pages of `page_size`
    tokens — docs/SERVING.md tuning notes). `warmup_shape` (one
    example's feature shape) precompiles every bucket before the socket
    opens; `warmup_async=True` opens the socket first and runs the
    warmup on a background thread, with `/readyz` answering 503 until
    it lands (how a fleet replica hides its spin-up cost behind the
    router, docs/FLEET.md). `max_queue` bounds the /predict coalescing
    queue and `max_waiting` the /generate admission queue — past
    either, requests shed with 503 + Retry-After. `prefix_cache=False`
    disables cross-request KV prefix sharing in the decode loop;
    individual requests opt out with `"prefix_cache": false` in the
    /generate body. `fleet_kv` tunes the fleet KV plane
    ("on"|"affinity-only"|"off", docs/FLEET.md "Fleet KV plane"): the
    affinity summary piggybacked on /readyz and the `POST /kv/export`
    peer page-shipping endpoint the router's donor hints point at.
    `decode_kernel` picks the decode attention lane
    ("auto" = the paged decode kernel on a CUDA device, the dense
    gather on the CPU). `horizon > 1` chains K decode
    steps per dispatch; `speculation = k > 0` turns on draft-and-verify
    speculative decoding instead (`drafter` "ngram" or "model" with
    `draft_params`/`draft_cfg`; requests opt out with
    `"speculation": false` in the /generate body and the reload route
    accepts `{"target": "draft"}` to canary new draft weights —
    docs/SERVING.md "Speculative decoding"). `checkpoint` ({path, step})
    stamps the initial checkpoint identity on the replicas when the
    served model came from a checkpoint — /readyz, /stats, and the
    fleet journal report it (docs/PIPELINE.md). Requests carry an SLO
    tier (`X-Priority` header or `"priority"` body field, interactive
    default): batch-tier work rides the bulk lane — shed first at
    lower water marks, admitted behind interactive, preemptible —
    and `batch_share` tunes its weighted-fair slice of the decode
    slots (docs/SERVING.md "Priority tiers"). `role` declares this
    replica's place in a disaggregated fleet (docs/FLEET.md
    "Disaggregated roles"): "unified" (default) serves everything;
    "prefill" computes prompt KV for handoff (`POST /prefill` +
    /kv/export, /generate rejected); "decode" owns the streams. A
    prefill role requires `prefix_cache=True` and `fleet_kv="on"`.
    `model_id` names the served model for the router's multi-model
    registry; both ride the /readyz payload.

    Warm start (`compilecache/`): `compile_cache=DIR` activates the
    program store for this process (pass engines built AFTER activation
    — or activate via `compilecache.activate` / `DL4J_TPU_COMPILE_CACHE`
    before constructing them — so their programs are store-wrapped).
    `warmup_plan` replays a recorded program set at warmup time: "auto"
    (default) looks for a plan in the active store's directory and is a
    silent no-op when there is none or no store is active; "off"
    disables replay; any other value is a plan file path. The handle
    re-records the plan after warmup and at close, so a replica's next
    boot warms exactly the program set this one used.
    """
    from deeplearning4j_tpu_torch import compilecache
    from deeplearning4j_tpu_torch.compilecache import warmup as _warmup_mod

    if compile_cache:
        compilecache.activate(compile_cache)
    if replicas is None:
        if net is None:
            raise ValueError("serve_network needs net= or replicas=")
        replicas = ReplicaSet.for_network(net, n_replicas=n_replicas,
                                          max_batch_size=max_batch_size)
    if checkpoint:
        # initial checkpoint identity (the model was constructed FROM a
        # checkpoint rather than reloaded onto a live server): stamp it
        # on every engine so /readyz reports it from the first probe
        for _e in replicas.engines:
            _e.checkpoint = dict(checkpoint)
    warm = tuple(warmup_shape) if warmup_shape is not None else None
    # slots=0 opts out of continuous batching: /generate falls back to
    # the per-request compiled-scan path (no streaming/EOS)
    if (generate_engine is not None and slots
            and generate_engine.decode_loop is None):
        generate_engine.start_decode_loop(slots=slots, page_size=page_size,
                                          n_pages=kv_pages,
                                          max_waiting=max_waiting,
                                          prefix_cache=prefix_cache,
                                          fleet_kv=fleet_kv,
                                          kv_ship_timeout=kv_ship_timeout,
                                          kernel=decode_kernel,
                                          horizon=horizon,
                                          speculation=speculation,
                                          drafter=drafter,
                                          draft_params=draft_params,
                                          draft_cfg=draft_cfg,
                                          draft_window=draft_window,
                                          batch_share=batch_share,
                                          role=role)
    batcher = replicas.batcher(max_batch_size=max_batch_size,
                               max_delay_ms=max_delay_ms,
                               max_queue=max_queue)
    # resolve the warmup plan: "auto" keys the plan off the first
    # cache-identified engine, inside the active store's directory —
    # record and replay coordinate through the directory alone
    plan_path = plan_doc = None
    if warmup_plan and warmup_plan != "off":
        if warmup_plan == "auto":
            cache_dir = compilecache.active_dir()
            identity = next(
                (getattr(e, "cache_key", None)
                 for e in ([generate_engine] if generate_engine else [])
                 + list(replicas.engines)
                 if getattr(e, "cache_key", None) is not None), None)
            if cache_dir and identity:
                # role-scoped plans: a prefill replica's plan never warms
                # the decode ladder (and vice versa)
                plan_path = _warmup_mod.auto_plan_path(cache_dir, identity,
                                                       role=role)
        else:
            plan_path = warmup_plan
        if plan_path:
            plan_doc = _warmup_mod.load_plan(plan_path)
    run_warmup = warm is not None or plan_doc is not None
    handle = ServingHandle(replicas, batcher, generate_engine,
                           warmup_pending=(run_warmup and warmup_async),
                           role=role, model_id=model_id)
    handle.warmup_plan = plan_doc
    handle.warmup_plan_path = plan_path
    if run_warmup and not warmup_async:
        handle._run_warmup(warm)

    class Handler(BaseHTTPRequestHandler):
        # chunked transfer (the streaming /generate response) needs
        # HTTP/1.1; every non-streaming reply carries Content-Length so
        # keep-alive connections frame correctly
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # quiet
            pass

        def _reply(self, code: int, payload: dict) -> None:
            self._reply_raw(code, "application/json",
                            json.dumps(payload).encode())

        def _reply_raw(self, code: int, ctype: str, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self) -> dict:
            if self._body is None:
                raise ValueError("missing request body")
            data = json.loads(self._body)
            if not isinstance(data, dict):
                raise ValueError("request body must be a JSON object")
            return data

        # ------------------------------------------------------- routes
        def do_GET(self):
            try:
                if self.path.startswith("/healthz"):
                    self._reply(200, {"ok": True,
                                      "replicas": len(replicas.engines)})
                elif self.path.startswith("/readyz"):
                    ready = handle.readiness()
                    self._reply(200 if ready["ready"] else 503, ready)
                elif self.path.startswith("/stats"):
                    self._reply(200, handle.stats())
                elif (hit := exposition.handle_metrics_get(
                        self.path)) is not None:
                    self._reply_raw(*hit)
                else:
                    self._reply(404, {"error": f"no route {self.path}"})
            except Exception as e:  # always answer with a status line
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def _reset_connection(self) -> None:
            """Abort the client connection with an RST (SO_LINGER 0),
            not a clean FIN — the injected "reset" socket fault."""
            import socket as _socket
            import struct as _struct

            try:
                self.connection.setsockopt(
                    _socket.SOL_SOCKET, _socket.SO_LINGER,
                    _struct.pack("ii", 1, 0))
            except OSError:
                pass
            self.close_connection = True
            try:
                self.connection.close()
            except OSError:
                pass

        def do_POST(self):
            try:
                # accept-then-hang / pre-read faults: the request is
                # accepted but the handler goes dark before reading or
                # answering anything (chaos "hang"/"delay"/"reset")
                chaos.hit("server.accept", path=self.path)
            except chaos.ChaosReset:
                self._reset_connection()
                return
            # slurp the body up front, before ANY reply: under
            # HTTP/1.1 keep-alive an unread body would desync the
            # connection — the leftover bytes parse as the client's
            # next request line (404-before-read was exactly that bug)
            length = int(self.headers.get("Content-Length") or 0)
            self._body = self.rfile.read(length) if length > 0 else None
            try:
                # slow-loris-shaped handler stall: body read, reply
                # withheld (chaos "delay"; errors surface as 500s)
                chaos.hit("server.read", path=self.path)
                if self.path.startswith("/predict"):
                    self._predict()
                elif self.path.startswith("/generate"):
                    self._generate()
                elif self.path.startswith("/reload"):
                    self._reload()
                elif self.path.startswith("/kv/export"):
                    self._kv_export()
                elif self.path.startswith("/prefill"):
                    self._prefill()
                else:
                    self._reply(404, {"error": f"no route {self.path}"})
            except chaos.ChaosReset:
                self._reset_connection()
            except FileNotFoundError as e:
                self._reply(404, {"error": str(e)})
            except OverloadedError as e:
                # machine-actionable shedding: 503 + Retry-After +
                # JSON body, same shape as the fleet router's shed
                self.send_response(503)
                self.send_header("Retry-After", str(e.retry_after_s))
                body = json.dumps(overload_body(e)).encode()
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except DeadlineExceededError as e:
                # the machine-readable twin for spent time budgets:
                # 504 + {"error": "deadline_exceeded", ...}
                _M_DEADLINE.inc()
                self._reply(504, deadline_body(e))
            except (ValueError, KeyError, TypeError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # engine-side failure
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def _predict(self):
            data = self._read_json()
            deadline = Deadline.from_request(self.headers, data)
            # SLO tier: X-Priority header wins, else "priority" body
            # field (interactive default; unknown values 400)
            tier = parse_tier(self.headers, data)
            chaos.hit("server.predict")
            inputs = np.asarray(data["inputs"], np.float32)
            # batcher.submit sheds an already-expired budget before
            # enqueueing, and re-checks at dispatch; batch-tier
            # requests shed first at the lower water mark
            fut: Future = batcher.submit(inputs, deadline=deadline,
                                         tier=tier)
            wait_s = (_RESULT_TIMEOUT_S if deadline is None
                      else deadline.timeout(_RESULT_TIMEOUT_S))
            try:
                out = fut.result(timeout=wait_s)
            except (FutureTimeoutError, TimeoutError):
                # abandon the future: if it is still queued, the
                # batcher drops it at dispatch instead of computing
                # an answer nobody is waiting for. Only a genuinely
                # SPENT budget becomes a 504 — a wait that hit the
                # engine-death backstop with budget remaining is an
                # engine failure (500), not the client's fault
                fut.cancel()
                if deadline is not None and deadline.expired:
                    raise DeadlineExceededError(
                        "deadline exceeded waiting for the batcher",
                        deadline_ms=deadline.budget_ms,
                        elapsed_ms=deadline.elapsed_ms()) from None
                raise
            self._reply(200, {
                "outputs": np.asarray(out).tolist(),
                "classes": np.argmax(out, axis=-1).astype(int).tolist(),
            })

        def _reload(self):
            data = self._read_json()
            path = data.get("path")
            if not path:
                raise ValueError("reload needs {'path': <checkpoint>}")
            step = data.get("step")
            step = None if step is None else int(step)
            target = data.get("target", "serving")
            if target == "draft":
                # canary path for the speculative draft model: swap
                # ONLY the drafter's weights; serving weights and
                # checkpoint identity are untouched
                info = handle.load_draft_checkpoint(str(path), step=step)
                self._reply(200, {
                    "reloaded": True,
                    "target": "draft",
                    "step": info.get("step"),
                    "replicas": len(replicas.engines),
                    "checkpoint": replicas.checkpoint,
                })
                return
            if target != "serving":
                raise ValueError(
                    f"reload target must be 'serving' or 'draft', "
                    f"got {target!r}")
            info = handle.load_checkpoint(str(path), step=step)
            self._reply(200, {
                "reloaded": True,
                "step": info.get("step"),
                "iterator_position": info.get("iterator_position"),
                "replicas": len(replicas.engines),
                "checkpoint": replicas.checkpoint,
            })

        def _kv_export(self):
            """Donor side of a fleet KV page ship (serving/fleetkv.py):
            serialize this replica's cached prefix pages for the
            requested head tokens. 404 while the plane is off —
            receivers treat any non-200 as "no donor", fall back to
            plain prefill, and move on."""
            loop = (generate_engine.decode_loop
                    if generate_engine is not None else None)
            if loop is None:
                self._reply(404, {"error": "no decode loop"})
                return
            data = self._read_json()
            tokens = data.get("tokens")
            if not isinstance(tokens, list) or not tokens:
                raise ValueError(
                    "kv export needs {'tokens': [head token ids]}")
            max_chunks = data.get("max_chunks")
            max_chunks = None if max_chunks is None else int(max_chunks)
            payload = loop.kv_export([int(t) for t in tokens],
                                     max_chunks=max_chunks)
            if payload is None:
                self._reply(404, {"error": "fleet KV shipping is off "
                                           "on this replica"})
                return
            self._reply_raw(200, "application/octet-stream", payload)

        def _prefill(self):
            """Prefill leg of a disaggregated handoff (docs/FLEET.md
            "Disaggregated roles"): run the prompt's full-page prefill
            on THIS replica and park the pages in its prefix trie —
            the router then sets the decode replica's `kv_donor` hint
            to this replica's URL so admission pulls the pages over
            /kv/export. Any role can donate (a unified replica's trie
            works the same way); a prefill-role replica serves ONLY
            this and /kv/export. Per row: `chunks` full pages in the
            prompt, `covered` already cached here, `cached` newly
            adopted, `kv_bytes` the page payload the handoff makes
            shippable."""
            loop = (generate_engine.decode_loop
                    if generate_engine is not None else None)
            if loop is None:
                self._reply(404, {"error": "no decode loop"})
                return
            data = self._read_json()
            deadline = Deadline.from_request(self.headers, data)
            raw = data.get("prompt", data.get("tokens"))
            if not isinstance(raw, list) or not raw:
                raise ValueError("prefill needs {'prompt': [token "
                                 "ids]} (flat row or list of rows)")
            if not isinstance(raw[0], list):
                raw = [raw]
            if deadline is not None:
                deadline.check("prefill")  # 504 before compute
            timeout = (None if deadline is None
                       else max(0.05, deadline.remaining_s()))
            reports = []
            for row in raw:
                tokens = [int(t) for t in row]
                if not tokens:
                    raise ValueError("prefill rows must be non-empty")
                reports.append(loop.prefill_only(tokens,
                                                 timeout=timeout))
            self._reply(200, {
                "chunks": sum(r["chunks"] for r in reports),
                "covered": sum(r["covered"] for r in reports),
                "cached": sum(r["cached"] for r in reports),
                "kv_bytes": sum(r["kv_bytes"] for r in reports),
                "rows": reports,
            })

        def _generate(self):
            if generate_engine is None:
                self._reply(404, {"error": "no generate engine configured"})
                return
            data = self._read_json()
            deadline = Deadline.from_request(self.headers, data)
            # SLO tier: X-Priority header wins, else "priority" body
            # field (interactive default; unknown values 400). Batch
            # rides the weighted-fair bulk lane and may be PREEMPTED —
            # the stream then finishes with reason "preempted" and its
            # already-emitted tokens still relay (the fleet router
            # turns that into a lossless durable-stream resume)
            tier = parse_tier(self.headers, data)
            chaos.hit("server.generate")
            raw = data["prompt"]
            if not isinstance(raw, list) or not raw:
                raise ValueError("prompt must be a non-empty token list "
                                 "or list of token lists")
            if not isinstance(raw[0], list):
                raw = [raw]  # single flat row
            # rows may be RAGGED — each slot decodes independently, so
            # unlike /predict there is no rectangularity requirement
            prompt = [np.asarray(row, np.int64).ravel() for row in raw]
            if any(row.size < 1 for row in prompt):
                raise ValueError("prompt rows must be non-empty")
            # "max_tokens" is the contract; "n_tokens" stays as the
            # legacy alias so pre-continuous-batching clients keep
            # working unchanged. A list gives each row its OWN budget
            # (failover continuations re-admit rows interrupted at
            # different depths as one group — docs/FLEET.md)
            max_tokens = data.get("max_tokens", data.get("n_tokens", 16))
            max_tokens = ([int(m) for m in max_tokens]
                          if isinstance(max_tokens, list)
                          else int(max_tokens))
            # absolute-index offset for streamed `token_index` chunks:
            # a resumed request's replayed tokens ride in as prompt, so
            # its first NEW token is not index 0 (scalar or per-row)
            base = data.get("token_index_base", 0)
            base = ([int(b) for b in base] if isinstance(base, list)
                    else int(base))
            eos_id = data.get("eos_id")
            eos_id = None if eos_id is None else int(eos_id)
            streaming = bool(data.get("stream", False))
            # per-request opt-out: a secret-bearing prompt must neither
            # read from nor seed the shared prefix cache
            use_prefix = bool(data.get("prefix_cache", True))
            # per-request speculation opt-out (no-op on loops without
            # speculation; output is bit-identical either way)
            use_spec = bool(data.get("speculation", True))
            loop = generate_engine.decode_loop
            if loop is None:
                # legacy per-request compiled-scan path (no slot
                # scheduler): fixed n_tokens, no EOS, no streaming
                if eos_id is not None or streaming:
                    raise ValueError(
                        "eos_id/stream need the continuous-batching "
                        "decode loop (serve with slots >= 1)")
                if isinstance(max_tokens, list):
                    raise ValueError(
                        "per-row max_tokens needs the continuous-"
                        "batching decode loop (serve with slots >= 1)")
                if deadline is not None:
                    deadline.check("generate")  # 504 before compute
                out = generate_engine.generate(np.asarray(prompt),
                                               max_tokens)
                self._reply(200, {"tokens": out.astype(int).tolist()})
                return
            # fleet KV plane donor hint (serving/fleetkv.py): the
            # router knows a peer holds this prompt's prefix hot —
            # fetch + install those pages BEFORE admission so the
            # match below sees them as cached chunks. Budget-derived
            # timeout; ANY failure just means plain prefill. Gated on
            # the same prefix_cache opt-out as the cache itself.
            donor = data.get("kv_donor")
            if donor and use_prefix:
                try:
                    # disagg handoff, install leg: a chaos fault here
                    # models the wire tearing at the worst moment —
                    # the pull is skipped and the request falls
                    # through to plain prefill, bit-identically
                    # (docs/FLEET.md "Disaggregated roles")
                    chaos.hit("disagg.handoff", role="install",
                              donor=str(donor))
                    ship_timeout = loop.kv_ship_timeout
                    if deadline is not None:
                        ship_timeout = max(
                            0.05, min(ship_timeout,
                                      0.5 * deadline.remaining_s()))
                    shipped = set()
                    for row in prompt:
                        head = tuple(
                            row[:(row.size // loop.page_size)
                                * loop.page_size].tolist())
                        if head and head not in shipped:
                            shipped.add(head)
                            loop.kv_ship(str(donor), list(head),
                                         timeout=ship_timeout)
                except Exception:
                    pass  # ANY handoff failure degrades to prefill
            # all-or-nothing admission: a malformed row 400s and an
            # admission shed 503s WITHOUT orphaning row-mates' streams
            # in running slots (submit_many validates every row, then
            # enqueues the whole group under one lock); an expired
            # deadline 504s at submit, and again at slot admission
            streams = loop.submit_many(prompt, max_tokens, eos_id,
                                       deadline=deadline,
                                       prefix_cache=use_prefix,
                                       token_index_base=base,
                                       speculation=use_spec,
                                       tier=tier)
            if streaming:
                self._stream_tokens(streams, deadline)
                return
            wait_s = (_RESULT_TIMEOUT_S if deadline is None
                      else deadline.timeout(_RESULT_TIMEOUT_S))
            try:
                rows = [s.full_sequence(wait_s) for s in streams]
            except BaseException as e:
                # deadline/timeout/error on any row: retire the whole
                # group's slots so no abandoned stream burns pages
                for s in streams:
                    s.cancel()
                if (deadline is not None and deadline.expired
                        and isinstance(e, TimeoutError)):
                    # the wall wait and the loop's own reap race; the
                    # client-visible verdict is the same either way
                    raise DeadlineExceededError(
                        "deadline exceeded waiting for generation",
                        deadline_ms=deadline.budget_ms,
                        elapsed_ms=deadline.elapsed_ms()) from None
                raise
            self._reply(200, {
                "tokens": rows,
                "finish_reasons": [s.finish_reason for s in streams],
            })

        def _stream_tokens(self, streams, deadline=None):
            """Chunked NDJSON: one line per emitted token, as the slots
            emit them, then a final summary line. The client sees
            first-token latency, not last-token latency.

            Every abnormal exit CANCELS the request's streams — a
            disconnected (or reset, or timed-out) client must not leave
            slots decoding into the void: cancellation retires them and
            frees their KV pages within one scheduler dispatch."""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(obj) -> None:
                chaos.hit("generate.midstream")
                body = (json.dumps(obj) + "\n").encode()
                self.wfile.write(f"{len(body):x}\r\n".encode()
                                 + body + b"\r\n")
                self.wfile.flush()

            try:
                self._relay_streams(streams, chunk, deadline)
            except chaos.ChaosReset:
                for s in streams:
                    s.cancel()
                self._reset_connection()
                return
            except DeadlineExceededError as e:
                # the decode loop's reap retired the slot on a spent
                # budget (the PRIMARY mid-stream enforcement): keep
                # the machine-readable wire shape in-band
                _M_DEADLINE.inc()
                for s in streams:
                    s.cancel()
                try:
                    chunk(deadline_body(e))
                except Exception:
                    self.close_connection = True
                    return
            except TimeoutError as e:
                # a stalled wait, NOT a disconnect (TimeoutError IS-A
                # OSError, so this arm must come first): the client is
                # still connected — cancel the slots and say why
                # in-band, with the machine-readable deadline shape
                # when a budget ran out
                for s in streams:
                    s.cancel()
                if deadline is not None and deadline.expired:
                    _M_DEADLINE.inc()
                    err = deadline_body(DeadlineExceededError(
                        "deadline exceeded mid-stream",
                        deadline_ms=deadline.budget_ms,
                        elapsed_ms=deadline.elapsed_ms()))
                else:
                    err = {"error": f"TimeoutError: {e}"}
                try:
                    chunk(err)
                except Exception:
                    self.close_connection = True
                    return
            except OSError:
                # the client hung up mid-stream: nothing left to tell
                # it — just stop burning its slots
                _M_DISCONNECTS.inc()
                for s in streams:
                    s.cancel()
                self.close_connection = True
                return
            except Exception as e:  # headers are gone — report in-band
                for s in streams:
                    s.cancel()
                try:
                    chunk({"error": f"{type(e).__name__}: {e}"})
                except Exception:
                    self.close_connection = True
                    return
            try:
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass
            self.close_connection = True

        def _relay_streams(self, streams, chunk, deadline=None) -> None:
            # the per-wait backstop: budget-carrying requests bound
            # every wait by their REMAINING budget (the decode loop's
            # reap is the primary enforcement; this covers a stalled
            # scheduler), budget-less ones keep the legacy constant
            def wait_s() -> float:
                return (_RESULT_TIMEOUT_S if deadline is None
                        else deadline.timeout(_RESULT_TIMEOUT_S))

            # every token line carries its ABSOLUTE per-row index
            # (token_index_base + emit ordinal): the fleet router's
            # failover dedupe key — exactly-once across replica hops
            # (clients that ignore it see the same stream as before)
            if len(streams) == 1:  # common case: emit inline
                for idx, tok in streams[0].indexed_tokens(
                        timeout=wait_s()):
                    chunk({"row": 0, "token": int(tok),
                           "token_index": int(idx)})
            else:  # merge rows as they emit, one relay thread per slot
                import queue as _queue
                import threading as _threading

                merged: "_queue.Queue" = _queue.Queue()

                def relay(r, s):
                    try:
                        for idx, tok in s.indexed_tokens(
                                timeout=wait_s()):
                            merged.put((r, int(idx), int(tok)))
                    except Exception:
                        pass  # surfaced via finish_reason below
                    finally:
                        merged.put((r, None, None))

                workers = [_threading.Thread(target=relay, args=(r, s),
                                             daemon=True)
                           for r, s in enumerate(streams)]
                for w in workers:
                    w.start()
                live = len(streams)
                while live:
                    r, idx, tok = merged.get()
                    if tok is None:
                        live -= 1
                    else:
                        chunk({"row": r, "token": tok,
                               "token_index": idx})
            chunk({"done": True,
                   "tokens": [s.prompt + s.result(wait_s())
                              if s.error is None else None
                              for s in streams],
                   "finish_reasons": [s.finish_reason for s in streams]})

    handle.http = start_http_server(Handler, host=host, port=port)
    if run_warmup and warmup_async:
        threading.Thread(target=handle._run_warmup, args=(warm,),
                         daemon=True, name="serve-warmup").start()
    return handle
