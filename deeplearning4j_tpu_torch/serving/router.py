"""Fleet router tier: the HTTP front end over out-of-process replicas.

The port's counterpart of the JAX package's `serving/router.py` (host
code; the same routes, bodies, status codes, headers and metric names).

Two pieces live here (the fleet state machine itself is
`serving/fleet.py`):

- `ReplicaClient` — a thin stdlib HTTP client for ONE replica serving
  endpoint (`serve_network`'s surface: /predict, /generate, /reload,
  /healthz, /readyz, /stats). One connection per call: the router's
  concurrency comes from its own handler threads, and a fresh
  connection per request means a dead replica fails THIS call with a
  clean OSError instead of poisoning a pooled socket.
- `serve_fleet(fleet)` — the router's own HTTP server (same
  utils/httpd.py lifecycle as every embedded server in the repo):

  - ``POST /predict``  — least-outstanding ready replica; connection
    failures and replica 5xx retry transparently on a healthy peer
    (idempotent, so at-least-once is safe); total-outstanding past the
    fleet's high-water mark sheds with 503 + Retry-After — per SLO
    tier: an `X-Priority: batch` request sheds at the batch lane's
    own lower mark and the header is forwarded to the replica.
  - ``POST /generate`` — DURABLE streams (docs/FLEET.md "Stream
    failover"): the router always drives the replica in streaming mode
    and keeps a per-stream continuation record — the request spec plus
    every token already relayed per row. When the serving replica
    dies, is breaker-evicted, or resets mid-stream, the router
    re-admits the unfinished rows on a surviving READY replica by
    submitting ``prompt + tokens-delivered-so-far`` as the new context
    (the prefix cache makes the replay prefill near-free; greedy
    argmax decode makes the continuation bit-identical) and resumes
    relaying from the first undelivered token, deduplicating by
    absolute ``token_index`` — the client sees every token exactly
    once. Resumes are bounded (``Fleet(stream_resume_attempts=)``) and
    budget-aware (the remaining ``X-Deadline-Ms`` shrinks across
    hops); exhaustion answers 502 with a structured
    ``{"error": "replica_failed", ..., "retryable": true,
    "resume_attempts": N}`` before the first byte, or the same object
    in-band as the final NDJSON line after it. Bodies the router can't
    parse into a continuation record degrade to the legacy blind
    passthrough (no resume).

    The SAME machinery makes slot preemption lossless
    (docs/SERVING.md "Priority tiers"): a batch row whose decode slot
    was evicted for an interactive arrival comes back with
    ``finish_reason: "preempted"`` — the router treats that as
    NON-terminal, keeps the row's continuation record, and re-admits
    it on the next free slot exactly like a failover resume, except it
    burns no ``stream_resume_attempts`` budget and excludes no
    replica (the preempting replica is healthy). A shed re-admission
    (503: the batch lane is full) waits out the tier-aware
    ``Retry-After`` and tries again.
    DISAGGREGATED fleets (docs/FLEET.md "Disaggregated roles") add a
    prefill handoff in front of the durable stream: when the fleet
    has READY prefill-role replicas, the router first drives
    ``POST /prefill`` on the least-loaded one — parking the prompt's
    full KV pages in that replica's prefix trie — and then names it
    as the decode placement's ``kv_donor`` so the decode replica
    pulls the pages peer-to-peer over ``/kv/export`` before its own
    (now trivial) prefill. ANY failure along the handoff degrades
    the stream to plain unified prefill, bit-identically (greedy
    argmax decode from the same causal context).

    MULTI-MODEL fleets route by model: an ``X-Model`` header (or a
    ``"model_id"`` body field on /generate) scopes replica selection,
    affinity placement, and the prefill handoff to replicas
    announcing that model in /readyz; absent both, any
    stream-capable replica serves (single-model fleets unchanged).
  - ``POST /reload``   — rolling/canary reload across the fleet
    (drain -> per-replica /reload -> /readyz probe -> readmit, one at
    a time; automatic rollback when the canary fails — Fleet.rolling_reload).
    A ``"model_id"`` field scopes the reload to one model's replicas.
  - ``POST /scale``    — autoscaling hook: ``{"replicas": N}`` spawns
    or retires to N (requires a spawner).
  - ``GET /healthz``   — router liveness + per-state replica counts.
  - ``GET /readyz``    — 200 iff at least one replica is ready.
  - ``GET /stats``     — Fleet.snapshot().
  - ``GET /metrics`` / ``/snapshot`` — the router process's telemetry
    registry: the `dl4j_fleet_*` series (docs/OBSERVABILITY.md).

Every reply slurps the POST body first (HTTP/1.1 keep-alive would
desync otherwise — the same lesson serving/server.py carries).
"""

from __future__ import annotations

import json
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler
from typing import Optional, Tuple

from deeplearning4j_tpu_torch.serving.errors import (DEADLINE_HEADER,
                                               PRIORITY_HEADER,
                                               TIER_INTERACTIVE, Deadline,
                                               DeadlineExceededError,
                                               OverloadedError,
                                               deadline_body,
                                               overload_body, parse_tier,
                                               replica_failed_body)
from deeplearning4j_tpu_torch.serving import fleetkv
from deeplearning4j_tpu_torch.telemetry import exposition
from deeplearning4j_tpu_torch.testing import chaos
from deeplearning4j_tpu_torch.utils.httpd import ServerHandle, start_http_server

__all__ = ["ReplicaClient", "FleetHandle", "serve_fleet"]


#: safety valves on the lossless-preemption loop. A batch stream under
#: constant interactive pressure can be preempted and re-admitted many
#: times (that is the design), but a pathological flood must not pin a
#: router thread forever: after this many preemption re-admissions the
#: stream fails with the in-band retryable shape instead.
_PREEMPT_RESUME_CAP = 64
#: ... and a re-admission that keeps getting SHED (batch lane full)
#: waits out Retry-After at most this many times (each wait is bounded
#: at 5s, so the worst case is minutes, not forever).
_PREEMPT_SHED_WAITS_CAP = 600


class _ClientGone(Exception):
    """The DOWNSTREAM client hung up mid-stream. Never attributed to
    the replica (a client closing its laptop must not evict a healthy
    replica) — the router just stops relaying and lets the replica-side
    connection close cancel the slots."""


class _RowState:
    """One row of a /generate continuation record: the original spec
    plus every token already relayed to the client. `prompt +
    delivered` is the replay context a resume submits; `len(delivered)`
    is both the next absolute token_index expected (the exactly-once
    dedupe key) and the amount to subtract from max_tokens on
    re-admission."""

    __slots__ = ("index", "prompt", "max_tokens", "delivered",
                 "finish_reason")

    def __init__(self, index: int, prompt, max_tokens: int):
        self.index = index            # row position in the CLIENT's request
        self.prompt = prompt          # original prompt token ids
        self.max_tokens = max_tokens  # original per-row budget
        self.delivered = []           # tokens already relayed, in order
        self.finish_reason = None     # set -> row is terminal


def _parse_continuation(data: dict):
    """Build the per-stream continuation record the failover engine
    keeps, or return None when the body doesn't speak the decode-loop
    contract (the router then degrades to the legacy blind passthrough
    and the replica's own validation answers). Returns
    (rows, eos_id, prefix_cache, speculation)."""
    try:
        raw = data["prompt"]
        if not isinstance(raw, list) or not raw:
            return None
        if not isinstance(raw[0], list):
            raw = [raw]
        prompts = []
        for row in raw:
            if not isinstance(row, list) or not row:
                return None
            prompts.append([int(t) for t in row])
        mt = data.get("max_tokens", data.get("n_tokens", 16))
        if isinstance(mt, list):
            if len(mt) != len(prompts):
                return None
            per_row = [int(m) for m in mt]
        else:
            per_row = [int(mt)] * len(prompts)
        if any(m < 1 for m in per_row):
            return None
        if "token_index_base" in data:
            # the router OWNS the dedupe offsets; a client already
            # speaking them is itself a resuming router — pass through
            return None
        eos = data.get("eos_id")
        eos = None if eos is None else int(eos)
        rows = [_RowState(i, p, m)
                for i, (p, m) in enumerate(zip(prompts, per_row))]
        return (rows, eos, bool(data.get("prefix_cache", True)),
                bool(data.get("speculation", True)))
    except (TypeError, ValueError, KeyError):
        return None


def _head_row(data: dict):
    """Best-effort first prompt row as an int list for affinity
    hashing on the passthrough path, or None when the body doesn't
    carry token ids (string prompts route by least-outstanding).
    Callers must already have checked the `prefix_cache` opt-out —
    opted-out token ids are never hashed."""
    raw = data.get("prompt")
    if not isinstance(raw, list) or not raw:
        return None
    row = raw[0] if isinstance(raw[0], list) else raw
    try:
        return [int(t) for t in row]
    except (TypeError, ValueError):
        return None


class ReplicaClient:
    """Stdlib HTTP client for one replica serving endpoint."""

    def __init__(self, url: str, timeout: float = 30.0):
        if "//" not in url:
            url = "http://" + url
        parsed = urllib.parse.urlsplit(url)
        if parsed.hostname is None or parsed.port is None:
            raise ValueError(
                f"replica url needs host:port, got {url!r}")
        self.host = parsed.hostname
        self.port = int(parsed.port)
        self.url = f"http://{self.host}:{self.port}"
        self.timeout = float(timeout)

    # ------------------------------------------------------------- raw
    def open(self, method: str, path: str, body: Optional[bytes] = None,
             timeout: Optional[float] = None,
             headers: Optional[dict] = None):
        """Issue a request and return (connection, response) with the
        body NOT yet read — the streaming proxy relays it chunk by
        chunk. The caller owns `connection.close()`. `headers` extends
        the defaults (how the router forwards `X-Deadline-Ms`)."""
        import http.client

        conn = http.client.HTTPConnection(
            self.host, self.port,
            timeout=self.timeout if timeout is None else timeout)
        hdrs = {"Content-Type": "application/json"} if body else {}
        if headers:
            hdrs.update(headers)
        try:
            conn.request(method, path, body=body, headers=hdrs)
            resp = conn.getresponse()
        except BaseException:
            conn.close()
            raise
        return conn, resp

    def request(self, method: str, path: str,
                body: Optional[bytes] = None,
                timeout: Optional[float] = None,
                headers: Optional[dict] = None
                ) -> Tuple[int, dict, bytes]:
        """One whole request: (status, headers-dict, body-bytes)."""
        conn, resp = self.open(method, path, body, timeout,
                               headers=headers)
        try:
            data = resp.read()
            return resp.status, dict(resp.getheaders()), data
        finally:
            conn.close()

    # ------------------------------------------------------ conveniences
    def get_json(self, path: str, timeout: Optional[float] = None
                 ) -> Tuple[int, dict]:
        status, _, data = self.request("GET", path, timeout=timeout)
        try:
            payload = json.loads(data) if data else {}
        except ValueError:
            payload = {"raw": data.decode(errors="replace")}
        return status, payload

    def healthz(self, timeout: Optional[float] = None) -> dict:
        """Liveness probe; raises on connection failure or non-200."""
        status, payload = self.get_json("/healthz", timeout)
        if status != 200:
            raise RuntimeError(f"healthz answered {status}")
        return payload

    def readyz(self, timeout: Optional[float] = None
               ) -> Tuple[bool, dict]:
        """Readiness probe: (ready, payload). Connection failures
        propagate (the caller distinguishes dead from not-ready)."""
        status, payload = self.get_json("/readyz", timeout)
        return status == 200, payload

    def stats(self, timeout: Optional[float] = None) -> dict:
        status, payload = self.get_json("/stats", timeout)
        if status != 200:
            raise RuntimeError(f"stats answered {status}")
        return payload


class FleetHandle:
    """A running fleet router: http handle + the fleet behind it."""

    def __init__(self, fleet, http: Optional[ServerHandle] = None):
        self.fleet = fleet
        self.http = http
        self.started_at = time.time()

    @property
    def url(self) -> str:
        return self.http.url

    @property
    def port(self) -> int:
        return self.http.port

    def close(self, stop_replicas: bool = False,
              handoff: bool = False) -> None:
        """Stop routing, then stop the fleet's control plane (and the
        spawned replica processes too when `stop_replicas`).
        `handoff=True` leaves the journaled replicas running for the
        next router incarnation to re-adopt (docs/FLEET.md "Router
        restart runbook")."""
        self.http.close()
        self.fleet.close(stop_replicas=stop_replicas, handoff=handoff)

    def __enter__(self) -> "FleetHandle":
        return self

    def __exit__(self, *exc) -> None:
        # mirror Fleet.__exit__: spawned replica processes die with the
        # context (attached-by-URL replicas are never touched)
        self.close(stop_replicas=True)


def serve_fleet(fleet, host: str = "127.0.0.1",
                port: int = 0,
                fleet_kv: str = fleetkv.MODE_ON) -> FleetHandle:
    """Start the router HTTP tier over a (started) Fleet.

    `fleet_kv` sets the router half of the fleet KV plane
    (docs/FLEET.md "Fleet KV plane"): ``"on"`` routes /generate by
    prefix affinity AND names a donor replica for peer-to-peer page
    shipping, ``"affinity-only"`` routes but never ships,
    ``"off"`` disables both (placement falls back to pure
    least-outstanding)."""
    from deeplearning4j_tpu_torch.serving.fleet import NoReadyReplicas

    affinity = fleetkv.RouterAffinity(fleet_kv)
    handle = FleetHandle(fleet)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # streaming passthrough needs it

        def log_message(self, *args):  # quiet
            pass

        def _reply(self, code: int, payload: dict,
                   extra_headers=()) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            for k, v in extra_headers:
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_raw(self, code: int, ctype: str, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_overloaded(self, e: OverloadedError) -> None:
            self._reply(503, overload_body(e),
                        extra_headers=[("Retry-After",
                                        str(e.retry_after_s))])

        # ----------------------------------------------------- routes
        def do_GET(self):
            try:
                if self.path.startswith("/healthz"):
                    self._reply(200, {"ok": True,
                                      "replicas": fleet.state_counts(),
                                      "incarnation": fleet.incarnation})
                elif self.path.startswith("/readyz"):
                    n = fleet.ready_count()
                    self._reply(200 if n else 503,
                                {"ready": n > 0, "ready_replicas": n})
                elif self.path.startswith("/stats"):
                    self._reply(200, {
                        "uptime_s": round(
                            time.time() - handle.started_at, 3),
                        "fleet": fleet.snapshot()})
                elif (hit := exposition.handle_metrics_get(
                        self.path)) is not None:
                    self._reply_raw(*hit)
                else:
                    self._reply(404, {"error": f"no route {self.path}"})
            except Exception as e:  # always answer with a status line
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def do_POST(self):
            # slurp the body BEFORE any reply (keep-alive framing)
            length = int(self.headers.get("Content-Length") or 0)
            self._body = self.rfile.read(length) if length > 0 else None
            try:
                chaos.hit("router.forward", path=self.path)
                if self.path.startswith("/predict"):
                    self._predict()
                elif self.path.startswith("/generate"):
                    self._generate()
                elif self.path.startswith("/reload"):
                    self._reload()
                elif self.path.startswith("/scale"):
                    self._scale()
                else:
                    self._reply(404, {"error": f"no route {self.path}"})
            except OverloadedError as e:
                self._reply_overloaded(e)
            except DeadlineExceededError as e:
                # the machine-readable budget-spent shape — same wire
                # contract as the replica server's 504
                self._reply(504, deadline_body(e))
            except NoReadyReplicas as e:
                self._reply(503, {"error": "no_ready_replicas",
                                  "detail": str(e)},
                            extra_headers=[("Retry-After", "1")])
            except (ValueError, KeyError, TypeError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def _read_json(self) -> dict:
            if self._body is None:
                raise ValueError("missing request body")
            data = json.loads(self._body)
            if not isinstance(data, dict):
                raise ValueError("request body must be a JSON object")
            return data

        def _model_id(self, data: Optional[dict] = None
                      ) -> Optional[str]:
            """The request's model scope: `X-Model` header first (the
            only channel /predict has — its body is forwarded raw),
            then a `"model_id"` body field. None routes un-scoped
            (any stream-capable replica — single-model fleets never
            pay the filter)."""
            mid = self.headers.get("X-Model")
            if not mid and isinstance(data, dict):
                mid = data.get("model_id")
            if mid is None:
                return None
            mid = str(mid).strip()
            return mid or None

        def _predict(self):
            if self._body is None:
                raise ValueError("missing request body")
            # header-borne budget (clients of the router speak the
            # header; the router forwards the SHRUNK remainder)
            deadline = Deadline.from_request(self.headers)
            # header-borne tier too: /predict bodies are forwarded
            # raw, so only `X-Priority` reaches the fleet's per-tier
            # admission here (a body-only "priority" field is still
            # honored by the replica's own batcher)
            tier = parse_tier(self.headers)
            status, headers, data = fleet.forward_predict(
                self._body, deadline=deadline, tier=tier,
                model_id=self._model_id())
            ctype = headers.get("Content-Type", "application/json")
            extra = [("Retry-After", headers["Retry-After"])] \
                if "Retry-After" in headers else []
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            for k, v in extra:
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _hop_budget(self, deadline, tier=TIER_INTERACTIVE):
            """Per-attempt (timeout, forwarded-headers, breaker-
            eligible) derived from the REMAINING budget — recomputed on
            every resume hop so the forwarded `X-Deadline-Ms` only ever
            shrinks, plus the forwarded `X-Priority` so the replica's
            decode admission applies the same tier. A timeout at a
            deadline-sliced window shorter than a fair wait says the
            CLIENT was impatient, not that the replica hung — same
            eligibility rule forward_predict applies
            (fleet.note_request_failure's contract)."""
            if deadline is None:
                hop_timeout, fwd_headers = fleet.generate_timeout, {}
            else:
                hop_timeout = deadline.timeout(fleet.generate_timeout)
                fwd_headers = {DEADLINE_HEADER: deadline.header_value()}
            if tier != TIER_INTERACTIVE:
                fwd_headers[PRIORITY_HEADER] = tier
            eligible = hop_timeout >= min(fleet.generate_timeout,
                                          fleet.probe_timeout)
            return hop_timeout, fwd_headers or None, eligible

        def _kv_place(self, tokens, use_prefix: bool,
                      model_id: Optional[str] = None):
            """Prefix-affinity placement for one request, or None.

            The opt-out contract (docs/FLEET.md): a body carrying
            `"prefix_cache": false` reaches this with `use_prefix`
            False and returns BEFORE any hashing — prompt-derived
            fingerprints of opted-out requests are never computed on
            the router, just as the replica never seeds its summary
            with them. A placement fault degrades to least-outstanding
            routing, never to a failed request. `model_id` scopes the
            summary set so cross-model prefixes never attract each
            other's traffic."""
            if not use_prefix or not affinity.enabled:
                return None
            try:
                return affinity.plan(
                    tokens, fleet.kv_summaries(model_id=model_id))
            except Exception:
                return None

        def _disagg_handoff(self, rows, deadline, tier,
                            model_id, use_prefix: bool):
            """The prefill leg of a disaggregated handoff: drive
            /prefill on the least-loaded prefill-role replica so the
            prompts' full KV pages are parked in ITS prefix trie,
            then return its URL for the decode placement's
            `kv_donor` hint (decode_loop.kv_ship pulls the pages
            peer-to-peer before prefill). Returns None — plain
            unified prefill, bit-identical — when the fleet has no
            prefill pool for this model, shipping is off, the prompt
            is shorter than one KV page, or ANY step of the dispatch
            fails."""
            import http.client as _hc

            if not use_prefix or not affinity.shipping:
                return None
            try:
                if fleet.role_counts(model_id).get("prefill", 0) < 1:
                    return None
                pre = fleet.select(route="generate", role="prefill",
                                   model_id=model_id, tier=tier,
                                   count=False)
            except Exception:
                return None  # no pool / shed: not a handoff failure
            try:
                hop_timeout, fwd_headers, eligible = \
                    self._hop_budget(deadline, tier)
                body = json.dumps(
                    {"prompt": [r.prompt for r in rows]}).encode()
                try:
                    status, _, raw = pre.client.request(
                        "POST", "/prefill", body,
                        timeout=hop_timeout, headers=fwd_headers)
                except (OSError, _hc.HTTPException) as e:
                    fleet.note_request_failure(
                        pre, e, breaker_eligible=eligible)
                    raise
                if status != 200:
                    raise RuntimeError(f"/prefill answered {status}")
                report = json.loads(raw)
                fleet.note_request_success(pre)
                if int(report.get("chunks") or 0) < 1:
                    # prompts shorter than one full page: nothing was
                    # parked, so a donor hint would buy nothing —
                    # neither a handoff nor a failure
                    return None
                fleet._m_disagg_handoffs.inc()
                fleet._m_disagg_handoff_bytes.inc(
                    int(report.get("kv_bytes") or 0))
                return pre.client.url
            except Exception:
                # ANY failure degrades to plain prefill on the decode
                # replica — the stream is bit-identical either way
                fleet._m_disagg_handoff_failures.inc()
                fleet._m_disagg_fallbacks.inc()
                return None
            finally:
                fleet.release(pre, tier)

        def _generate(self):
            data = self._read_json()  # parsed for stream/deadline
            streaming = bool(data.get("stream", False))
            deadline = Deadline.from_request(self.headers, data)
            tier = parse_tier(self.headers, data)  # unknown -> 400
            if deadline is not None and deadline.expired:
                fleet._m_deadline["generate"].inc()
                deadline.check("router dispatch")  # raises -> 504
            parsed = _parse_continuation(data)
            model_id = self._model_id(data)
            start = time.perf_counter()
            try:
                if parsed is None:
                    self._generate_passthrough(streaming, deadline,
                                               tier, data, model_id)
                else:
                    self._generate_durable(parsed, streaming, deadline,
                                           tier, model_id)
            except _ClientGone:
                self.close_connection = True
            finally:
                fleet.observe("generate", time.perf_counter() - start,
                              tier=tier)

        def _generate_durable(self, parsed, streaming, deadline, tier,
                              model_id=None):
            """Failover-durable /generate: drive the replica in
            streaming mode (even for a non-streaming client), fold its
            NDJSON into the continuation record, and on replica failure
            re-admit the unfinished rows on a survivor with
            `prompt + delivered` as the new context. The client's
            response headers are sent LAZILY — while no byte has been
            relayed, a total failure can still answer a clean 502.

            Preemption rides the same loop: rows finishing with
            `"preempted"` stay non-terminal and re-admit on the next
            iteration — with `attempt` still 0, so a preemption resume
            burns no failover budget, excludes no replica, and a shed
            re-admission waits out the tier-aware Retry-After."""
            import http.client as _hc

            rows, eos_id, use_prefix, use_spec = parsed
            replica_errs = (OSError, _hc.HTTPException)
            failed = []        # replica ids excluded from resume placement
            resumes = 0        # successful re-admissions (stream opened)
            resume_tried = 0   # resume attempts started (reported on fail)
            preempt_resumes = 0  # lossless preemption re-admissions
            preempt_waits = 0    # shed re-admissions waited out
            preempt_pending = False  # next stream-open IS a preempt resume
            state = {"headers_sent": False}

            def chunk(obj: dict) -> None:
                # lazy headers: the first relayed line commits us to the
                # in-band error contract; before it, status codes work
                try:
                    if not state["headers_sent"]:
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "application/x-ndjson")
                        self.send_header("Transfer-Encoding", "chunked")
                        self.end_headers()
                        state["headers_sent"] = True
                    raw = (json.dumps(obj) + "\n").encode()
                    self.wfile.write(f"{len(raw):x}\r\n".encode()
                                     + raw + b"\r\n")
                    self.wfile.flush()
                except _ClientGone:
                    raise
                except Exception as e:
                    raise _ClientGone(str(e)) from e

            def end_chunked() -> None:
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except Exception:
                    pass
                self.close_connection = True

            def reply_complete() -> None:
                reasons = [r.finish_reason for r in rows]
                toks = [r.prompt + r.delivered
                        if r.finish_reason not in ("error",
                                                   "deadline_exceeded")
                        else None
                        for r in rows]
                if streaming:
                    done_line = {"done": True, "tokens": toks,
                                 "finish_reasons": reasons,
                                 "resumes": resumes}
                    if preempt_resumes:
                        done_line["preempt_resumes"] = preempt_resumes
                    chunk(done_line)
                    end_chunked()
                elif "deadline_exceeded" in reasons:
                    self._reply(504, {"error": "deadline_exceeded",
                                      "detail": "generation deadline "
                                      "exceeded on the replica",
                                      "finish_reasons": reasons})
                elif "error" in reasons:
                    self._reply(500, {"error": "generation failed",
                                      "finish_reasons": reasons})
                else:
                    out = {"tokens": toks, "finish_reasons": reasons}
                    if resumes:
                        out["resumes"] = resumes
                    if preempt_resumes:
                        out["preempt_resumes"] = preempt_resumes
                    self._reply(200, out)

            def reply_inband(obj: dict) -> None:
                # the replica spoke a terminal in-band error (deadline,
                # chaos reset already surfaced as JSON, ...): relay its
                # shape, NOT a replica failure
                if streaming:
                    chunk(obj)
                    end_chunked()
                elif obj.get("error") == "deadline_exceeded":
                    self._reply(504, obj)
                else:
                    self._reply(500, obj)

            def reply_failed(replica_id, detail: str) -> None:
                # resume budget exhausted (attempts or deadline): the
                # in-band retryable fallback, now carrying how many
                # resumes were burned
                fleet._m_stream_resume_failures.inc()
                body = replica_failed_body(replica_id, detail,
                                           resume_attempts=resume_tried)
                if state["headers_sent"]:
                    chunk(body)
                    end_chunked()
                else:
                    self._reply(502, body)

            # affinity placement hashes only the PROMPT head (chunk-
            # aligned), so one plan covers every hop: delivered tokens
            # extend the tail, never the head. Opted-out bodies skip
            # the hash entirely (use_prefix False -> None).
            placement = self._kv_place(rows[0].prompt, use_prefix,
                                       model_id)
            # disaggregated handoff (prefill-role pool only): park the
            # prompt KV on a prefill replica and name it as donor for
            # the FIRST hop. Resume hops replay prompt + delivered on
            # a survivor; the parked pages are stale for that longer
            # context, so resumes use the affinity donor path instead.
            handoff_donor = self._disagg_handoff(
                rows, deadline, tier, model_id, use_prefix)
            affinity_noted = False
            attempt = 0
            last = (None, "no replica attempted")  # (id, detail)
            while True:
                pending = [r for r in rows if r.finish_reason is None]
                if not pending:
                    reply_complete()
                    return
                if attempt > 0:
                    # ---------------- a failover resume: bounded + budget-aware
                    if attempt > fleet.stream_resume_attempts:
                        reply_failed(*last)
                        return
                    if deadline is not None and deadline.expired:
                        reply_failed(last[0], f"{last[1]} (deadline "
                                     "spent before resume)")
                        return
                    resume_tried += 1
                    try:
                        chaos.hit("router.stream_resume",
                                  attempt=attempt, replica=last[0])
                    except Exception as e:
                        last = (last[0], f"resume blocked: "
                                f"{type(e).__name__}: {e}")
                        attempt += 1
                        continue
                    prefer = (placement.prefer
                              if placement is not None
                              and placement.prefer not in failed
                              else None)
                    try:
                        replica = fleet.select(
                            route="generate",
                            exclude=tuple(failed),
                            tier=tier, prefer=prefer,
                            prefer_slack=fleetkv.PLACEMENT_SLACK,
                            model_id=model_id)
                    except (NoReadyReplicas, OverloadedError) as e:
                        reply_failed(last[0], f"{last[1]}; no surviving "
                                     f"replica to resume on ({e})")
                        return
                else:
                    try:
                        replica = fleet.select(
                            route="generate", tier=tier,
                            count=not preempt_pending,
                            prefer=(placement.prefer
                                    if placement is not None else None),
                            prefer_slack=fleetkv.PLACEMENT_SLACK,
                            model_id=model_id)
                    except OverloadedError:
                        if not preempt_pending:
                            raise  # initial admission: shed the client
                        # a preemption re-admission shed at the FLEET
                        # mark: same backpressure as a replica-side
                        # 503 — wait a beat and try again
                        preempt_waits += 1
                        if preempt_waits > _PREEMPT_SHED_WAITS_CAP or (
                                deadline is not None
                                and deadline.expired):
                            reply_failed(last[0], "preempted stream "
                                         "could not re-admit (fleet "
                                         "overloaded)")
                            return
                        time.sleep(0.2)
                        continue
                if placement is not None and not affinity_noted:
                    # scored once per stream, on first placement: hit =
                    # the summaries matched AND the request landed on
                    # the matched replica
                    affinity_noted = True
                    fleet.note_affinity(placement.depth > 0 and
                                        replica.id == placement.prefer)
                hop_timeout, fwd_headers, eligible = \
                    self._hop_budget(deadline, tier)
                body = {
                    # replay context: everything the client already has
                    "prompt": [r.prompt + r.delivered for r in pending],
                    "max_tokens": [r.max_tokens - len(r.delivered)
                                   for r in pending],
                    "stream": True,
                    "prefix_cache": use_prefix,
                    # the client's speculation opt-in/out survives the
                    # failover hop (output is bit-identical either way —
                    # this preserves intent, not correctness)
                    "speculation": use_spec,
                    # absolute indices resume where delivery stopped, so
                    # dedupe below is a pure integer comparison
                    "token_index_base": [len(r.delivered)
                                         for r in pending],
                }
                if eos_id is not None:
                    body["eos_id"] = eos_id
                if (handoff_donor is not None and attempt == 0
                        and not preempt_pending):
                    # disaggregated handoff: the prefill replica just
                    # parked this prompt's pages — it outranks any
                    # affinity donor for the first hop
                    body["kv_donor"] = handoff_donor
                elif (affinity.shipping and placement is not None
                        and placement.depth > 0
                        and placement.donor_url
                        and replica.id != placement.donor
                        and placement.donor not in failed):
                    # the request landed OFF the replica holding its
                    # cached head (shed pressure, SUSPECT, slack): name
                    # the donor so the receiver ships the hot pages
                    # peer-to-peer before prefill (decode_loop.kv_ship
                    # — any ship failure falls back to plain prefill)
                    body["kv_donor"] = placement.donor_url
                replayed = sum(len(r.prompt) + len(r.delivered)
                               for r in pending)
                conn = None
                try:
                    try:
                        conn, resp = replica.client.open(
                            "POST", "/generate",
                            json.dumps(body).encode(),
                            timeout=hop_timeout, headers=fwd_headers)
                    except replica_errs as e:
                        fleet.note_request_failure(
                            replica, e, breaker_eligible=eligible)
                        failed.append(replica.id)
                        last = (replica.id, f"{type(e).__name__}: {e}")
                        attempt += 1
                        continue
                    if resp.status != 200:
                        raw = resp.read()
                        if preempt_pending and attempt == 0:
                            if resp.status == 503:
                                # a preemption re-admission was SHED
                                # (batch lane full): honor the
                                # tier-aware Retry-After, bounded by
                                # the remaining budget — backpressure,
                                # not failure; no failover budget
                                # burned, nobody excluded
                                fleet.note_request_success(replica)
                                preempt_waits += 1
                                if preempt_waits > \
                                        _PREEMPT_SHED_WAITS_CAP:
                                    reply_failed(
                                        replica.id,
                                        "preempted stream could not "
                                        "re-admit (lane stayed full)")
                                    return
                                ra = resp.getheader("Retry-After")
                                try:
                                    wait = (min(float(ra), 5.0)
                                            if ra else 0.2)
                                except ValueError:
                                    wait = 0.2
                                if deadline is not None:
                                    if deadline.expired:
                                        reply_failed(
                                            replica.id,
                                            "deadline spent re-"
                                            "admitting a preempted "
                                            "stream")
                                        return
                                    wait = min(wait, max(
                                        0.05, deadline.remaining_s()))
                                time.sleep(wait)
                                continue
                            # any other refusal mid-preemption-resume:
                            # headers may already be out, so speak the
                            # in-band retryable shape, never a raw
                            # status line
                            reply_failed(
                                replica.id,
                                "preempted stream re-admission "
                                f"refused: HTTP {resp.status}")
                            return
                        if attempt > 0:
                            # a survivor refusing the resume (shedding,
                            # validation): exclude it and keep going
                            failed.append(replica.id)
                            last = (replica.id,
                                    f"resume refused: HTTP {resp.status}")
                            attempt += 1
                            continue
                        fleet.note_request_success(replica)
                        if resp.status == 400:
                            # the replica rejected the streaming upgrade
                            # (no decode loop): nothing was delivered
                            # yet, so forward the ORIGINAL body untouched
                            # and relay whatever the replica says
                            self._relay_plain(replica, hop_timeout,
                                              fwd_headers, eligible)
                            return
                        extra = []
                        ra = resp.getheader("Retry-After")
                        if ra:
                            extra.append(("Retry-After", ra))
                        ctype = resp.getheader("Content-Type",
                                               "application/json")
                        self.send_response(resp.status)
                        self.send_header("Content-Type", ctype)
                        for k, v in extra:
                            self.send_header(k, v)
                        self.send_header("Content-Length", str(len(raw)))
                        self.end_headers()
                        self.wfile.write(raw)
                        return
                    if attempt > 0:
                        resumes += 1
                        fleet._m_stream_resumes.inc()
                        fleet._m_stream_tokens_replayed.inc(replayed)
                    elif preempt_pending:
                        # a lossless preemption re-admission opened:
                        # counted apart from failover resumes, but the
                        # replayed-context accounting is the same (the
                        # prefix cache absorbs the replay either way)
                        preempt_resumes += 1
                        fleet._m_preempt_resumes.inc()
                        fleet._m_stream_tokens_replayed.inc(replayed)
                    preempt_pending = False
                    kind, payload = self._relay_continuation(
                        resp, pending, eos_id,
                        chunk if streaming else None)
                    if kind == "broken":
                        fleet.note_request_failure(
                            replica, payload, breaker_eligible=eligible)
                        failed.append(replica.id)
                        last = (replica.id,
                                f"{type(payload).__name__}: {payload}")
                        attempt += 1
                        continue
                    fleet.note_request_success(replica)
                    if kind == "inband":
                        reply_inband(payload)
                        return
                    if kind == "preempted":
                        # `payload` rows lost their batch slot to an
                        # interactive arrival; their continuation
                        # records are intact, so the next iteration
                        # re-admits them — attempt stays 0 (no
                        # failover budget burned, no exclusion)
                        if preempt_resumes >= _PREEMPT_RESUME_CAP:
                            reply_failed(
                                replica.id,
                                f"preempted {preempt_resumes} times "
                                "without finishing (resume cap)")
                            return
                        preempt_pending = True
                        last = (replica.id, "slot preempted")
                        continue
                    # kind == "done": loop re-checks pending (empty
                    # unless the replica under-reported — it won't)
                finally:
                    if conn is not None:
                        conn.close()
                    fleet.release(replica, tier)

        def _relay_continuation(self, resp, pending, eos_id, emit):
            """Fold one replica's NDJSON stream into the continuation
            record, relaying token chunks via `emit` (None buffers for
            a non-streaming client). Returns:

            - ("done", None)    — the replica finished every row;
            - ("preempted", n)  — the stream ended cleanly but n rows
              lost their batch slot to an interactive arrival
              (`finish_reason: "preempted"`); their records stay
              NON-terminal and the caller re-admits them losslessly;
            - ("inband", obj)   — terminal in-band error object
              (deadline and friends — NOT a replica failure);
            - ("broken", exc)   — the replica died / hung / broke the
              protocol mid-stream; the caller resumes elsewhere.

            Exactly-once is enforced HERE: every token chunk carries an
            absolute `token_index`; anything below the next expected
            index was already relayed before the failover and is
            dropped (deduped), a gap above it means lost tokens and is
            treated as a replica failure so the resume replays them."""
            try:
                while True:
                    line = resp.readline()  # http.client de-chunks
                    if not line:
                        return ("broken", ConnectionError(
                            "replica stream ended without a done line"))
                    if not line.endswith(b"\n"):
                        return ("broken", ConnectionError(
                            "replica stream died mid-line"))
                    if not line.strip():
                        continue
                    try:
                        obj = json.loads(line)
                    except ValueError:
                        return ("broken", ConnectionError(
                            "undecodable stream line from replica"))
                    if obj.get("done"):
                        reasons = obj.get("finish_reasons") or []
                        n_preempted = 0
                        for li, row in enumerate(pending):
                            if row.finish_reason is None:
                                reason = (reasons[li]
                                          if li < len(reasons)
                                          else "error")
                                if reason == "preempted":
                                    # NOT terminal: the row keeps its
                                    # continuation record and the
                                    # caller re-admits it on the next
                                    # free slot (lossless preemption)
                                    n_preempted += 1
                                else:
                                    row.finish_reason = reason
                        if n_preempted:
                            return ("preempted", n_preempted)
                        return ("done", None)
                    if "token" in obj:
                        li = obj.get("row", 0)
                        if not isinstance(li, int) \
                                or not 0 <= li < len(pending):
                            return ("broken", ConnectionError(
                                f"stream row {li!r} out of range"))
                        row = pending[li]
                        expected = len(row.delivered)
                        idx = int(obj.get("token_index", expected))
                        if idx < expected:
                            # a replayed token the client already has
                            fleet._m_stream_tokens_deduped.inc()
                            continue
                        if idx > expected:
                            return ("broken", ConnectionError(
                                f"token index gap (got {idx}, "
                                f"expected {expected})"))
                        tok = int(obj["token"])
                        row.delivered.append(tok)
                        if eos_id is not None and tok == eos_id:
                            row.finish_reason = "eos"
                        elif len(row.delivered) >= row.max_tokens:
                            row.finish_reason = "max_tokens"
                        if emit is not None:
                            # rewrite to the CLIENT's row numbering
                            emit({"row": row.index, "token": tok,
                                  "token_index": idx})
                        continue
                    if "error" in obj:
                        return ("inband", obj)
                    # unknown line shape: tolerate (forward-compat)
            except _ClientGone:
                raise
            except Exception as e:
                return ("broken", e)

        def _relay_plain(self, replica, hop_timeout, fwd_headers,
                         eligible) -> None:
            """Re-forward the client's ORIGINAL body to `replica` and
            relay the whole reply — the legacy escape hatch when the
            replica rejected the router's streaming upgrade (a serve
            process without a decode loop still answers plain
            /generate)."""
            import http.client as _hc

            try:
                status, headers, data = replica.client.request(
                    "POST", "/generate", self._body,
                    timeout=hop_timeout, headers=fwd_headers)
            except (OSError, _hc.HTTPException) as e:
                fleet.note_request_failure(replica, e,
                                           breaker_eligible=eligible)
                self._reply(502, replica_failed_body(
                    replica.id, f"{type(e).__name__}: {e}"))
                return
            if status < 500:
                fleet.note_request_success(replica)
            extra = [("Retry-After", headers["Retry-After"])] \
                if "Retry-After" in headers else []
            ctype = headers.get("Content-Type", "application/json")
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            for k, v in extra:
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _generate_passthrough(self, streaming, deadline,
                                  tier=TIER_INTERACTIVE, data=None,
                                  model_id=None):
            """The pre-failover path, kept for bodies that don't parse
            into a continuation record (string prompts, exotic fields,
            a client that is itself a resuming router): one replica,
            blind relay, no resume (a preempted row surfaces its
            `"preempted"` finish_reason to the client unresumed).
            Affinity still places token-list bodies (the body is
            forwarded untouched, so no donor hint is injected here —
            the affinity hit itself makes shipping unnecessary)."""
            placement = None
            if data is not None and bool(data.get("prefix_cache",
                                                  True)):
                tokens = _head_row(data)
                if tokens:
                    placement = self._kv_place(tokens, True, model_id)
            replica = fleet.select(
                route="generate", tier=tier,
                prefer=(placement.prefer
                        if placement is not None else None),
                prefer_slack=fleetkv.PLACEMENT_SLACK,
                model_id=model_id)
            if placement is not None:
                fleet.note_affinity(placement.depth > 0 and
                                    replica.id == placement.prefer)
            import http.client as _hc

            replica_errs = (OSError, _hc.HTTPException)
            try:
                hop_timeout, fwd_headers, eligible = \
                    self._hop_budget(deadline, tier)
                try:
                    conn, resp = replica.client.open(
                        "POST", "/generate", self._body,
                        timeout=hop_timeout, headers=fwd_headers)
                except replica_errs as e:
                    # failed before any byte reached the client: fail
                    # FAST with a structured, retryable error
                    fleet.note_request_failure(replica, e,
                                               breaker_eligible=eligible)
                    self._reply(502, replica_failed_body(
                        replica.id, f"{type(e).__name__}: {e}"))
                    return
                try:
                    if streaming and resp.status == 200:
                        self._relay_stream(replica, resp,
                                           breaker_eligible=eligible)
                        return
                    try:
                        body = resp.read()
                    except replica_errs as e:
                        # replica died mid-body; the client has seen
                        # nothing yet, so the structured 502 still fits
                        fleet.note_request_failure(
                            replica, e, breaker_eligible=eligible)
                        self._reply(502, replica_failed_body(
                            replica.id, f"{type(e).__name__}: {e}"))
                        return
                    if resp.status < 500:
                        fleet.note_request_success(replica)
                    extra = []
                    ra = resp.getheader("Retry-After")
                    if ra:
                        extra.append(("Retry-After", ra))
                    ctype = resp.getheader("Content-Type",
                                           "application/json")
                    self.send_response(resp.status)
                    self.send_header("Content-Type", ctype)
                    for k, v in extra:
                        self.send_header(k, v)
                    self.send_header("Content-Length",
                                     str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                finally:
                    conn.close()
            finally:
                fleet.release(replica, tier)

        def _relay_stream(self, replica, resp,
                          breaker_eligible: bool = True) -> None:
            """Chunked NDJSON passthrough; a mid-stream replica failure
            is reported in-band (headers are long gone). Replica reads
            and client writes fail SEPARATELY: only a replica-side
            failure is attributed to the replica — a client hanging up
            must never evict a healthy replica."""
            self.send_response(200)
            self.send_header("Content-Type",
                             resp.getheader("Content-Type",
                                            "application/x-ndjson"))
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(raw: bytes) -> None:
                self.wfile.write(f"{len(raw):x}\r\n".encode()
                                 + raw + b"\r\n")
                self.wfile.flush()

            try:
                while True:
                    try:
                        piece = resp.readline()  # http.client de-chunks
                    except Exception as e:  # replica died mid-stream
                        fleet.note_request_failure(
                            replica, e, breaker_eligible=breaker_eligible)
                        chunk((json.dumps({
                            "error": "replica_failed",
                            "replica": replica.id,
                            "detail": f"{type(e).__name__}: {e}"})
                            + "\n").encode())
                        break
                    if not piece:
                        fleet.note_request_success(replica)
                        break
                    chunk(piece)
                self.wfile.write(b"0\r\n\r\n")
            except Exception:  # client hung up: nothing left to tell it
                pass
            self.close_connection = True

        def _reload(self):
            data = self._read_json()
            path = data.get("path")
            if not path:
                raise ValueError("reload needs {'path': <checkpoint>}")
            step = data.get("step")
            rb_step = data.get("rollback_step")
            mid = data.get("model_id")
            result = fleet.rolling_reload(
                str(path), step=None if step is None else int(step),
                rollback_path=data.get("rollback_path"),
                rollback_step=None if rb_step is None else int(rb_step),
                probe=data.get("probe"),
                model_id=None if mid is None else str(mid))
            self._reply(200 if result.get("reloaded") else 409, result)

        def _scale(self):
            data = self._read_json()
            n = data.get("replicas")
            if not isinstance(n, int) or n < 0:
                raise ValueError("scale needs {'replicas': N >= 0}")
            result = fleet.scale_to(n)
            self._reply(200, result)

    handle.http = start_http_server(Handler, host=host, port=port)
    return handle
