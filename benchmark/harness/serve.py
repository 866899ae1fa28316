"""Serving cells: the port's `InferenceEngine` with its continuous-batching
`DecodeLoop`, driven by one client thread. The configuration's
`model_type` names the module that makes the weights, the engine and
the reference (`models/<model_type>.py`, `common.served_model`).

The client submits through `generate_stream` and gives each stream a
token queue that stamps every token with the host's clock as the
scheduler hands it over (`StampedQueue`); it sweeps the live streams for
finished ones and never blocks on one. It keeps `slots + backlog`
requests live: a finished one is replaced at once (a closed loop).

A run: weights from the seed on the card; the engine and loop; the
step graph captured and every prefill group shape the mix can meet run
once (`warm_programs`); `warmup_s` of the mix's own traffic; the
window. Then a seeded sample of the finished requests is taken with the
longest among them, the device's peak is read, the program is freed,
and the float32 reference reads each served token's gap below its best
logit.
"""

from __future__ import annotations

import gc
import queue
import sys
import time

import torch

from harness import common, traffic
from reference.fp8 import strict_float32

#: seconds the client sleeps between sweeps of the live streams for the
#: finished ones (tokens are stamped where they are queued)
POLL_S = 0.010


class StampedQueue(queue.Queue):
    """A stream's token queue that stamps every item put into it with the
    host's clock, on the thread that puts it: the moment a client reading
    the stream could first see the token. (The stream's end marker adds
    one stamp after the last token.)"""

    def __init__(self, stamps: list):
        super().__init__()
        self.stamps = stamps

    def put(self, item, block=True, timeout=None):
        self.stamps.append(time.perf_counter())
        super().put(item, block, timeout)


def prefill_groups(loop, mix: dict) -> list:
    """Every (batch bucket, prompt bucket) prefill group the mix can
    form on this loop."""
    lo, hi = mix["prompt"]["low"], mix["prompt"]["high"]
    buckets = [b for i, b in enumerate(loop._buckets)
               if b >= lo and (i == 0 or loop._buckets[i - 1] < hi)]
    rows, bb = [], 1
    while bb <= loop.slots:
        rows.append(bb)
        bb *= 2
    if rows[-1] < loop.slots:
        rows.append(1 << (loop.slots - 1).bit_length())
    return [[r, b] for r in rows for b in buckets]


class Client:
    """The benchmark's one client thread (the caller's)."""

    def __init__(self, engine, requests, mix):
        self.engine = engine
        self.pending = list(requests)   # not yet submitted, in order
        self.live = []
        self.done = []
        self.target = engine.decode_loop.slots + int(mix["backlog"])

    def _submit(self, r, now) -> None:
        r.sent = now
        r.stream = self.engine.generate_stream(r.prompt, r.max_tokens)
        old, r.stream._q = r.stream._q, StampedQueue(r.times)
        while True:  # a token put before the swap: stamped now
            try:
                r.stream._q.put(old.get_nowait())
            except queue.Empty:
                break
        self.live.append(r)

    def _poll(self, now) -> None:
        still = []
        for r in self.live:
            s = r.stream
            if s.done:
                r.seen = len(s._generated)
                del r.times[r.seen:]  # the end marker's stamp
                r.finished = now
                r.failed = s.error is not None or \
                    s.finish_reason not in ("max_tokens", "eos")
                self.done.append(r)
            else:
                still.append(r)
        self.live = still

    def run_until(self, t_stop: float) -> None:
        """Keep `target` requests live until the host clock reaches
        t_stop."""
        while True:
            now = time.perf_counter()
            if now >= t_stop:
                break
            while self.pending and len(self.live) < self.target:
                self._submit(self.pending.pop(0), now)
            now = time.perf_counter()
            self._poll(now)
            time.sleep(max(0.0, min(POLL_S, t_stop - now)))

    def cancel_rest(self) -> None:
        for r in self.live:
            r.stream.cancel()


def window_stats(client: Client, t0: float, t1: float) -> dict:
    """What the client saw in [t0, t1]: the tokens, the prompt length of
    each first token, each decode token's cursor (prompt length + index
    - 1), the requests sent in it, and the failed requests."""
    reqs = client.done + client.live
    tokens = 0
    decode_cursors, firsts = [], []
    for r in reqs:
        plen = len(r.prompt)
        # a stream's end marker, stamped but not yet trimmed, is no token
        n = len(r.stream._generated) if r.stream is not None else r.seen
        for i, t in enumerate(r.times[:n]):
            if t0 <= t <= t1:
                tokens += 1
                if i == 0:
                    firsts.append(plen)
                else:
                    decode_cursors.append(plen + i - 1)
    return {"tokens": tokens, "first_prompts": firsts,
            "decode_cursors": decode_cursors,
            "sent": sum(1 for r in reqs
                        if r.sent is not None and t0 <= r.sent < t1),
            "failed": sum(1 for r in reqs if r.failed)}


def report_window(snap0, snap1, stats, client) -> None:
    """One line on standard error: the loop's counters over the window
    beside what the client saw (a diagnostic, read by no metric)."""
    keys = ("dispatches", "tokens_streamed", "requests", "admission_waits",
            "prefill_tokens")
    delta = {k: snap1[k] - snap0[k] for k in keys if k in snap1}
    print(f"serve: window counters {delta}; at its close occupied "
          f"{snap1['occupied_slots']} queued {snap1['queued']} pages in use "
          f"{snap1['pages_in_use']} (peak {snap1.get('peak_pages_in_use')}) "
          f"free {snap1['pages_free']} cached "
          f"{snap1['prefix_cache']['pages_cached']}; client saw "
          f"{stats['tokens']} tokens, {len(stats['first_prompts'])} first "
          f"tokens, {len(client.live)} live, {len(client.pending)} unsent",
          file=sys.stderr)


def sample(client: Client, seed: int, want_tokens: int) -> list:
    """A seeded sample of the finished requests holding at least
    `want_tokens` served tokens, the longest finished request first."""
    ok = [r for r in client.done if not r.failed and r.seen == r.max_tokens]
    if not ok:
        return []
    longest = max(ok, key=lambda r: (len(r.prompt) + r.max_tokens, -r.idx))
    order = traffic.rng_for(seed, 9).permutation(len(ok))
    picked, n = [longest], longest.max_tokens
    for i in order:
        if n >= want_tokens:
            break
        if ok[i] is not longest:
            picked.append(ok[i])
            n += ok[i].max_tokens
    return picked


def widest_gaps(model, params32, dims: dict, picked,
                precisions=("float32",)):
    """For each precision, the widest gap over the sampled requests'
    served tokens (`model.served_gaps`, `models/__init__.py`), and the
    number of served tokens judged."""
    worst = {p: 0.0 for p in precisions}
    count = 0
    for r in picked:
        served = r.stream.result(timeout=0)
        ref_logits = None
        for p in precisions:
            gaps, ref_logits = model.served_gaps(
                params32, dims, r.prompt.tolist(), served, p, ref_logits)
            worst[p] = max(worst[p], float(gaps.max()))
        count += len(served)
        del ref_logits
    return worst, count


class Served:
    """The program under test, set up: the kernel library loaded, the
    weights made from the seed on the card, the engine and its decode
    loop with the step graph captured and every prefill group shape of
    the mix run once."""

    def __init__(self, spec, seed: int, device, parts: dict):
        from deeplearning4j_tpu_torch import _build

        cfg, mix = spec.config, spec.traffic
        self.model = common.served_model(cfg)
        self.dm = self.model.dims(cfg)
        self.dtype = getattr(torch, cfg["torch_dtype"])
        self.serving = cfg["serving"]
        self.device, self.seed = device, seed
        t = time.perf_counter()
        if device.type == "cuda":
            _build.library()
        parts["library_s"] = time.perf_counter() - t
        t = time.perf_counter()
        params = self.model.make_params(self.dm, seed, device, self.dtype)
        common.sync(device)
        parts["weights_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.engine = self.model.make_engine(params, self.dm, self.dtype,
                                             device, self.serving)
        self.loop = self.engine.decode_loop
        self.loop.warm_programs({"cache_key": self.loop.cache_key,
                                 "step": True,
                                 "prefill": prefill_groups(self.loop, mix)})
        parts["capture_s"] = time.perf_counter() - t

    def close(self) -> None:
        """Stop the loop and free the program's device memory."""
        self.engine.close()
        self.engine = self.loop = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_params(self):
        """The reference's float32 copy of the seed's weights, made
        anew."""
        return self.model.reference_params(self.dm, self.seed, self.device,
                                           self.dtype)


def drive(served: Served, mix: dict, seed: int, seconds: float,
          trace=None, parts=None) -> dict:
    """The mix's warm-up traffic, then the window of `seconds` (the
    profiler on over its last `trace_s` when a trace is given)."""
    requests = traffic.serve_requests(mix, served.dm["vocab_size"], seed)
    client = Client(served.engine, requests, mix)
    if trace is not None:
        trace.prepare()
    t = time.perf_counter()
    client.run_until(t + float(mix["warmup_s"]))
    if parts is not None:
        parts["warm_traffic_s"] = time.perf_counter() - t
    loop = served.loop
    gc.collect()
    out = {"client": client, "setup_end": time.perf_counter()}
    snap0 = loop.snapshot()
    t0 = time.perf_counter()
    t1 = t0 + seconds
    tr0 = tr1 = None
    if trace is not None:
        client.run_until(max(t0, t1 - float(mix["trace_s"])))
        a = time.perf_counter()
        trace.start()
        client._poll(time.perf_counter())
        tr0 = time.perf_counter()
        out["trace_start_s"] = tr0 - a
    client.run_until(t1)
    tr1 = time.perf_counter()
    snap1 = loop.snapshot()
    if trace is not None:
        trace.mark_end()
    stats = window_stats(client, t0, t1)
    out.update(snap0=snap0, snap1=snap1, t0=t0, t1=t1, stats=stats,
               traced=(window_stats(client, tr0, tr1) if trace is not None
                       else None),
               traced_s=(tr1 - tr0) if trace is not None else None)
    report_window(snap0, snap1, stats, client)
    return out


def run(spec, args, device, t_start: float) -> dict:
    cfg, mix = spec.config, spec.traffic
    parts = {"import_s": time.perf_counter() - t_start}
    served = Served(spec, args.seed, device, parts)
    trace = common.DeviceTrace(device) if args.trace else None
    w = drive(served, mix, args.seed, args.seconds, trace, parts)
    setup_s = w["setup_end"] - t_start
    if "trace_start_s" in w:
        parts["trace_start_s"] = w["trace_start_s"]
    client, stats = w["client"], w["stats"]
    picked = sample(client, args.seed, int(mix["sample_tokens"]))
    client.cancel_rest()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    served.close()
    if trace is not None:  # read once the loop's thread has ended
        t = time.perf_counter()
        trace.finish()
        parts["trace_read_s"] = time.perf_counter() - t

    # the reference, on the program's freed memory
    strict_float32()
    params32 = served.reference_params()
    gaps, judged = widest_gaps(served.model, params32, served.dm, picked)
    del params32
    limits = spec.limits
    checks = {"requests_failed": common.check(stats["failed"], 0),
              "served_tokens_judged": {
                  "value": float(judged), "limit": float(limits["min_judged"]),
                  "ok": judged >= limits["min_judged"]},
              "max_logit_gap": common.check(gaps["float32"],
                                            limits["max_logit_gap"])}
    window_s = args.seconds
    e2e = {"serve_tokens_per_s": stats["tokens"] / window_s,
           "setup_s": setup_s}
    ctx = {"window_s": window_s, "stats": stats, "snap0": w["snap0"],
           "snap1": w["snap1"], "dims": served.dm,
           "dtype": cfg["torch_dtype"], "serving": served.serving,
           "trace": trace, "traced": w["traced"], "traced_s": w["traced_s"]}
    summary = trace.summary() if trace is not None else None
    ctx["trace_summary"] = summary
    return {"e2e": e2e, "ctx": ctx, "checks": checks,
            "attempted": stats["sent"], "failed": stats["failed"],
            "peak": peak, "setup_parts": parts, "trace": summary}
