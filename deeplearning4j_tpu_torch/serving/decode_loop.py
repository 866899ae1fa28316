"""Continuous-batching decode loop over a paged KV pool — the counterpart
of the JAX package's `serving/decode_loop.py`.

- a fixed pool of **S slots** rides one decode step
  (`paged_kv.paged_decode_step` + on-device argmax feedback). Slot
  membership is a per-slot `stop` bound on the device, never a shape:
  requests join and leave at token boundaries;
- KV lives in a **paged block pool**: a request holds
  `ceil(tokens/page_size)` pages, pages return to the pool the moment it
  completes, and admission is a free-page check;
- a **scheduler thread** admits queued prompts into freed slots between
  steps (batched, bucketed `paged_prefill` scatters the prompts' K/V into
  their pages) and emits tokens onto per-request `GenerationStream`s;
- per-slot **max_tokens / EOS** termination, cancellation and deadlines
  free a slot and its pages immediately.

The device carry — last tokens, page table, lengths, stop bounds — lives
in persistent device buffers that feed straight back into the next step;
the host re-fills them (one synchronous copy of every control array)
only after a visible event (admission, completion, page grant). Prefill
first tokens stay on the device until the next step has been dispatched.
All device work runs on the scheduler thread's current CUDA stream; an
exception there fails every in-flight and queued stream (`_fail_all`),
and the callers see it from `result()`.

**Decode horizon** (`horizon=K`): one dispatch runs K chained decode
steps with on-device argmax feedback, each slot gated by `lengths <
stop`, so a slot never writes past its token budget or its granted
pages; the host copies one (K, S) token array back and trims EOS
overshoot. **CUDA graph**: on a CUDA device the fixed-shape step chain is
captured once as a `torch.cuda.CUDAGraph` (on the scheduler thread, at
the first dispatch) and replayed for every dispatch; so is the verify
step under speculation. That is this package's counterpart of the JAX
package's single jitted program: `decode_step_programs()` counts the
captured graphs (1 plain; 2 with speculation, both captured at the
first dispatch). On the CPU the step runs eagerly and
`decode_step_programs()` counts the distinct step shapes run. A failed
capture raises; nothing gives way to the eager step on the card. A
capture runs no kernel, so the wrappers' `launches` counters leave it
out; `graph_launches()` counts what the replays launched (replays x the
launches the capturing thread recorded into each graph). Entering a
capture synchronizes the whole device and empties the allocator's cache,
which would break a capture another loop of the same process has
under way (a fleet's replicas on threads of one process), so captures
take a process-wide lock (`_CAPTURE_LOCK`) one at a time.

**Prefix cache** (`prefix_cache=True`, the default): a radix trie over
page-aligned token chunks (`prefix_cache.PrefixIndex`) sits in front of
admission. Pages are REFCOUNTED: a prompt whose leading full chunks are
cached maps those pages by reference and prefills only the uncovered
tail (`paged_prefill_ctx`); a fully covered prompt skips prefill and
replays its last prompt token through the decode step. Shared pages are
read-only: the copy-on-write guard forks (`copy_page`) every shared page
a dispatch is about to write, and stalls the slot at the shared frontier
when no page is free. A retiring request seeds the trie with its full
prompt pages (never forked ones); an LRU tier evicts unreferenced cached
pages on demand. Every page is in exactly one of: the free list, in use
(refcount > 0), or cached-unreferenced. `submit*(..., prefix_cache=False)`
neither matches nor seeds.

**Speculative decoding** (`speculation=k`): each round a drafter
(`speculation.py`: "ngram" prompt lookup over the slot's history and the
trie, or "model", a small draft transformer) proposes up to k tokens per
slot, ONE widened verify step (`paged_kv.paged_verify_step`, K4 once per
column on the card) scores all of them, and the longest run matching the
target's own argmax is accepted plus the target's token at the first
mismatch: output is identical to plain decode. Rollback is the host
cursor not moving. `submit*(..., speculation=False)` rides at width 1.
Speculation and `horizon > 1` are mutually exclusive.

**SLO tiers** (`tier="interactive"|"batch"` on submit): interactive
arrivals go ahead of batch ones at admission (FIFO within a tier); batch
holds at most `batch_share` of the slots while interactive work is live
and soaks idle slots otherwise; batch sheds at its own lower
`batch_max_waiting` bound with a backlog-derived Retry-After; a blocked
interactive admission preempts the batch slot with the fewest emitted
tokens (finish_reason "preempted"), whose full prompt pages seed the
prefix cache.

Backpressure: a request is admitted only when the pool (free list plus
evictable cached pages) can cover its prompt plus the first decode
write; a mid-flight slot that needs a page with none available stops
advancing until a completion frees pages. If every occupied slot is
stalled and nothing can free a page, the stalled streams fail with an
error instead of deadlocking.

**Fleet KV plane** (`fleet_kv="on"|"affinity-only"|"off"`, default "on",
forced off without the prefix cache; serving/fleetkv.py): `kv_summary()`
fingerprints the trie for the readiness probe; `kv_export(tokens)`
serializes the cached pages covering a prompt's head (the donor half of
a page ship); `kv_ship(donor_url, tokens)` fetches a donor's pages and
installs the ones this trie lacks (the receiver half), so the next
admission prefills only the tail. Any ship failure falls back to plain
prefill. Installs and prefills run on the scheduler thread (the kv job
queue serviced at the top of every tick); the pool is written in place.

**Roles** (`role="unified"|"prefill"|"decode"`): a prefill-role loop
refuses streams and only computes prompt KV into its trie
(`prefill_only`) for a decode replica to pull over `/kv/export`; it never
dispatches a decode step, so it never captures a graph. A decode-role
loop is a unified loop the fleet routes streams at.

Telemetry: dl4j_kv_pages_total / dl4j_kv_pages_in_use /
dl4j_kv_pages_shared / dl4j_kv_pages_cached / dl4j_decode_active_slots
gauges, dl4j_decode_requests / dl4j_decode_tokens_streamed /
dl4j_decode_admission_waits / dl4j_decode_steps / dl4j_decode_shed /
dl4j_decode_deadline_exceeded / dl4j_decode_cancelled /
dl4j_kv_prefix_{hits,misses,forks,evictions} / dl4j_spec_* /
dl4j_tier_* / dl4j_decode_kv_read_bytes{path} counters and the
dl4j_decode_step_seconds histogram, under the JAX package's names, help
strings and labels. Chaos points: `decode.step`, `decode.fork`,
`fleet.kv_summary`, `fleet.kv_ship`, `disagg.handoff`.

`kernel="auto"|"kernel"|"gather"` picks the decode attention read
(`attention.paged.resolve_decode_kernel`).

**Warmup plans** (`compilecache/`): the step, verify, prefill,
warm-tail prefill and copy programs go through `compilecache.bind_program`
under the loop's `cache_key`, so with a program store active each is a
store signature (`_program(name, ...)` runs one, through its dispatcher
when there is one). `plan_fragment()` records which ran (the prefill groups
by shape); `warm_programs(frag)` replays them on the scheduler thread —
prefill groups on pad rows, the step and verify graphs captured, the
draft rollout run — so a fresh loop meets no new program in traffic.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
import weakref
from collections import deque
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device, telemetry
from deeplearning4j_tpu_torch.attention import flash, paged
from deeplearning4j_tpu_torch.attention.paged import resolve_decode_kernel
from deeplearning4j_tpu_torch.models.transformer import TransformerConfig
from deeplearning4j_tpu_torch.serving import fleetkv
from deeplearning4j_tpu_torch.serving.errors import (TIER_BATCH,
                                                     TIER_INTERACTIVE, TIERS,
                                                     Deadline,
                                                     DeadlineExceededError,
                                                     OverloadedError,
                                                     backlog_retry_ms)
from deeplearning4j_tpu_torch.serving.paged_kv import (copy_page,
                                                       decode_read_bytes,
                                                       extract_pages,
                                                       init_paged_pool,
                                                       install_pages,
                                                       paged_decode_step,
                                                       paged_kv_bytes,
                                                       paged_prefill,
                                                       paged_prefill_ctx,
                                                       paged_verify_step,
                                                       pages_for_tokens,
                                                       pages_per_slot,
                                                       prompt_buckets)
from deeplearning4j_tpu_torch.serving.prefix_cache import PrefixIndex
from deeplearning4j_tpu_torch.serving.speculation import build_drafter
from deeplearning4j_tpu_torch.testing import chaos
from deeplearning4j_tpu_torch.utils.digest import config_digest
from deeplearning4j_tpu_torch.weights import params_to_device

__all__ = ["GenerationStream", "DecodeLoop", "ROLES", "ROLE_UNIFIED",
           "ROLE_PREFILL", "ROLE_DECODE"]

_DONE = object()
_loop_seq = itertools.count()

#: replica roles: a `unified` loop serves prefill AND decode (the
#: default); a `prefill` loop only computes prompt KV into its trie for
#: `/kv/export` handoff (submit is refused, so it never dispatches a
#: decode step); a `decode` loop is a unified loop the fleet routes
#: streams at — the tag places work, it does not change loop behaviour
ROLE_UNIFIED = "unified"
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLES = (ROLE_UNIFIED, ROLE_PREFILL, ROLE_DECODE)

#: per-queued-item service estimate feeding the backlog-derived
#: Retry-After on a tier shed
_TIER_ITEM_MS = {TIER_INTERACTIVE: 50.0, TIER_BATCH: 250.0}
#: the kernels a captured graph records: name -> the wrapper's count of
#: launches the calling thread recorded under capture
_CAPTURED_LAUNCHES = {"paged_decode": paged.captured_launches,
                      "flash_fwd": flash.captured_launches}
#: one graph capture at a time in this process: `torch.cuda.graph`
#: synchronizes the device and frees cached blocks on entry, which
#: invalidates a capture under way on another loop's scheduler thread
_CAPTURE_LOCK = threading.Lock()


class _Counts(dict):
    """Per-loop counters mirrored into the telemetry registry: `add(key,
    n)` bumps the dict (what `snapshot()` reads, exact with telemetry
    off too) and that key's registry series."""

    def __init__(self, series: dict):
        super().__init__({key: 0 for key in series})
        self._series = series

    def add(self, key, n: int = 1) -> None:
        self[key] += n
        self._series[key].inc(n)


class GenerationStream:
    """One in-flight generate request: a token queue the scheduler pushes
    into as the slot emits, plus the blocking `result()`.

    `tokens()` yields generated token ids as they are emitted; `result()`
    blocks until the stream finishes and returns the generated list;
    `full_sequence()` is prompt + generated. `finish_reason` is "eos",
    "max_tokens", "cancelled", "deadline_exceeded", "preempted" (a batch
    slot evicted for an interactive arrival; error stays None) or
    "error" once done."""

    def __init__(self, prompt: Sequence[int], max_tokens: int,
                 eos_id: Optional[int],
                 deadline: Optional[Deadline] = None):
        self.prompt: List[int] = [int(t) for t in prompt]
        self.max_tokens = int(max_tokens)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.deadline = deadline
        #: False = neither matches nor seeds the shared prefix cache
        self.prefix_cache = True
        #: False = no drafts for this request (its slot rides every
        #: verify round at width 1)
        self.speculation = True
        #: SLO tier: "interactive" or "batch"
        self.tier = TIER_INTERACTIVE
        #: absolute index of the FIRST token this stream will emit —
        #: non-zero for a failover continuation whose delivered tokens
        #: ride in as prompt; the streaming front end adds it to each
        #: token's `token_index` (the router's exactly-once dedupe key)
        self.token_index_base = 0
        self.finish_reason: Optional[str] = None
        self.error: Optional[BaseException] = None
        self._generated: List[int] = []
        self._q: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._cancelled = threading.Event()
        self._loop_ref = None  # weakref to the owning loop, set at submit

    # ------------------------------------------------- scheduler side
    def _emit(self, token: int) -> None:
        self._generated.append(int(token))
        self._q.put(int(token))

    def _finish(self, reason: str,
                error: Optional[BaseException] = None) -> None:
        self.finish_reason = reason
        self.error = error
        self._q.put(_DONE)
        self._done.set()

    # --------------------------------------------------- client side
    def tokens(self, timeout: Optional[float] = None) -> Iterator[int]:
        """Yield generated tokens as they are emitted; raises the
        stream's error (if it failed) after the last delivered token.
        `timeout` bounds the wait between tokens."""
        while True:
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"no token emitted within {timeout}s") from None
            if item is _DONE:
                if self.error is not None:
                    raise self.error
                return
            yield item

    def indexed_tokens(self, timeout: Optional[float] = None
                       ) -> Iterator[tuple]:
        """`tokens()` with each token's absolute index attached: yields
        `(token_index_base + n, token)` for the n-th emitted token."""
        for n, tok in enumerate(self.tokens(timeout=timeout)):
            yield self.token_index_base + n, tok

    def __iter__(self) -> Iterator[int]:
        return self.tokens()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def cancel(self) -> bool:
        """Retire this request at the scheduler's next pass (slot and
        pages released). Idempotent; True when the stream had not
        finished yet."""
        if self._done.is_set():
            return False
        self._cancelled.set()
        loop = self._loop_ref() if self._loop_ref is not None else None
        if loop is not None:
            with loop._cond:
                loop._cond.notify_all()
        return True

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until finished; return the generated token ids (EOS
        included when it fired)."""
        if not self._done.wait(timeout):
            raise TimeoutError("generation still in flight")
        if self.error is not None:
            raise self.error
        return list(self._generated)

    def full_sequence(self, timeout: Optional[float] = None) -> List[int]:
        return self.prompt + self.result(timeout)


class _Slot:
    __slots__ = ("stream", "pages", "awaiting_first", "emitted", "stop_len",
                 "no_cache")

    def __init__(self, stream: GenerationStream, pages: List[int],
                 stop_len: int):
        self.stream = stream
        self.pages = pages        # physical page ids, in logical order
        #: prefill's first token is still on the device (_deferred)
        self.awaiting_first = True
        self.emitted = 0          # tokens pushed onto the stream so far
        self.stop_len = stop_len  # final length: prompt + max_tokens - 1
        #: pages forked by copy-on-write: they never seed the cache
        self.no_cache: set = set()


class _Graph:
    """One captured step, the kernel launches each replay makes (per
    kernel name) and the wall milliseconds its warm-up and capture
    took."""

    __slots__ = ("graph", "launches", "replays", "capture_ms")

    def __init__(self, graph, launches: dict, capture_ms: float):
        self.graph = graph
        self.launches = launches
        self.replays = 0
        self.capture_ms = capture_ms


class DecodeLoop:
    """Owns the paged pool, the page tables, the decode step and the
    scheduler thread. `submit()` is thread-safe and returns a
    `GenerationStream`."""

    def __init__(self, params, cfg: TransformerConfig, *, slots: int = 8,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 horizon: int = 1, max_waiting: Optional[int] = None,
                 prefix_cache: bool = True, fleet_kv: str = "on",
                 kv_ship_timeout: float = 2.0,
                 kernel: str = "auto", speculation: int = 0,
                 drafter: str = "ngram", draft_params=None, draft_cfg=None,
                 draft_window: int = 32, ngram: int = 3,
                 batch_share: float = 0.5,
                 batch_max_waiting: Optional[int] = None,
                 role: str = ROLE_UNIFIED, device=None, start: bool = True,
                 name: Optional[str] = None):
        if role not in ROLES:
            raise ValueError(
                f"role must be one of {ROLES}, got {role!r}")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        if speculation < 0:
            raise ValueError(
                f"speculation must be >= 0, got {speculation}")
        if speculation and horizon > 1:
            raise ValueError(
                "speculation and horizon>1 are mutually exclusive: "
                "speculation replaces the horizon chain with "
                "draft-and-verify chunking (pick one)")
        if max_waiting is not None and max_waiting < 0:
            raise ValueError(f"max_waiting must be >= 0, got {max_waiting}")
        if not 0.0 < batch_share <= 1.0:
            raise ValueError(
                f"batch_share must be in (0, 1], got {batch_share}")
        if batch_max_waiting is not None and batch_max_waiting < 0:
            raise ValueError(
                f"batch_max_waiting must be >= 0, got {batch_max_waiting}")
        self.device = default_device(device)
        self.cfg = cfg
        self.params = params_to_device(params, self.device)
        self.role = role
        self.slots = int(slots)
        self.page_size = int(page_size)
        self.horizon = int(horizon)
        #: drafts per verify round (0 = speculation off)
        self.spec_k = int(speculation)
        self.kernel_requested = kernel
        self.decode_kernel = resolve_decode_kernel(kernel, cfg,
                                                   self.page_size,
                                                   self.device)
        self._pps = pages_per_slot(cfg, self.page_size)
        if n_pages is None:
            # worst case: every slot at max_len
            n_pages = self.slots * self._pps
        self.n_pages = int(n_pages)
        #: admission-queue bound: a submit that cannot start now while
        #: this many requests of its tier already wait sheds with
        #: OverloadedError
        self.max_waiting = None if max_waiting is None else int(max_waiting)
        #: while interactive work is live, batch holds at most this share
        #: of the slots; with no interactive demand batch soaks them all
        self.batch_share = float(batch_share)
        self._batch_slot_cap = max(1, int(round(self.slots
                                                * self.batch_share)))
        #: the batch lane's own (lower) admission-queue bound; defaults
        #: to half the interactive bound
        if batch_max_waiting is not None:
            self.batch_max_waiting: Optional[int] = int(batch_max_waiting)
        elif self.max_waiting is not None:
            self.batch_max_waiting = self.max_waiting // 2
        else:
            self.batch_max_waiting = None
        self._tier_waiting = {t: 0 for t in TIERS}
        self._buckets = prompt_buckets(cfg, self.page_size)

        # device state ------------------------------------------------
        S, P, dev = self.slots, self._pps, self.device
        self._pool = init_paged_pool(cfg, self.n_pages, self.page_size, dev)
        self._trash = self._pool.trash_page
        # every control array of the step lives in ONE host buffer and
        # ONE persistent device buffer (views below), so an upload is
        # one synchronous copy into storage a captured graph reads
        self._h_ctrl = np.zeros((S * (3 + P),), np.int32)
        self._d_ctrl = torch.zeros((S * (3 + P),), dtype=torch.int32,
                                   device=dev)
        self._pending, self._lengths, self._stop, self._table = \
            self._ctrl_views(self._h_ctrl, S, P)
        self._table[:] = self._trash
        self._d_tokens, self._d_lengths, self._d_stop, self._d_table = \
            self._ctrl_views(self._d_ctrl, S, P)
        #: the step chain's tokens, (horizon, S)
        self._d_out = torch.zeros((self.horizon, S), dtype=torch.int32,
                                  device=dev)
        self._dirty = True          # mirrors changed since last upload
        self._free: deque = deque(range(self.n_pages))
        self._slot_state: List[Optional[_Slot]] = [None] * self.slots
        #: prefill-group first tokens still on the device:
        #: [(device (B,) tensor, [(row, slot_idx), ...])]
        self._deferred: List = []
        # prefix sharing: per-page reader refcounts + the chunk trie
        self.prefix_cache_enabled = bool(prefix_cache)
        self._prefix: Optional[PrefixIndex] = (
            PrefixIndex(self.page_size) if self.prefix_cache_enabled
            else None)
        self._ref = np.zeros((self.n_pages,), np.int32)
        # fleet KV plane: affinity summaries + peer page shipping. The
        # plane rides the prefix trie, so without a trie it is off.
        if fleet_kv not in fleetkv.MODES:
            raise ValueError(
                f"fleet_kv must be one of {fleetkv.MODES}, "
                f"got {fleet_kv!r}")
        self.fleet_kv = (fleet_kv if self.prefix_cache_enabled
                         else fleetkv.MODE_OFF)
        if self.role == ROLE_PREFILL and self.fleet_kv != fleetkv.MODE_ON:
            # the trie + /kv/export wire ARE a prefill replica's whole
            # product: without them it could never hand pages to anyone
            raise ValueError(
                "a prefill-role loop needs prefix_cache=True and "
                "fleet_kv='on' — its only output is cached KV pages "
                "shipped over /kv/export")
        #: pool-writing jobs (shipped-page installs, handoff prefills)
        #: queued for the scheduler thread, which runs every device write
        #: to the pool on its own stream
        self._kv_jobs: deque = deque()
        #: cumulative ship stats, reported in the readiness summary
        self._ship_stats = {"page_ships": 0, "ship_bytes": 0,
                            "ship_failures": 0}
        #: CUDA event recorded on the scheduler thread's stream after the
        #: last write into pages the trie may hold (prefill, install);
        #: an export read on another thread waits on it (kv_export)
        self._pool_event = None
        if kv_ship_timeout <= 0:
            raise ValueError(f"kv_ship_timeout must be > 0, "
                             f"got {kv_ship_timeout}")
        #: default budget for one donor fetch + install (seconds)
        self.kv_ship_timeout = float(kv_ship_timeout)
        #: the decode identity a shipped page must match: model config,
        #: page size, kernel lane, horizon, speculation width, device
        self.cache_key = (
            f"decode:{config_digest(cfg)}|ps={self.page_size}"
            f"|k={self.decode_kernel}|h={self.horizon}"
            f"|spec={self.spec_k}|dev={self.device}")
        # the program store (compilecache): a dispatcher a program when
        # the process activated one (each program a store signature),
        # else None
        from deeplearning4j_tpu_torch import compilecache as _cc

        key = self.cache_key
        self._step = _cc.bind_program(self._run_program, key + "|step",
                                      "step")
        self._verify = _cc.bind_program(self._run_program,
                                        key + "|verify", "verify")
        self._prefill = _cc.bind_program(self._prefill_program,
                                         key + "|prefill")
        self._prefill_ctx = _cc.bind_program(self._prefill_ctx_program,
                                             key + "|prefill_ctx")
        self._copy = _cc.bind_program(self._copy_program, key + "|copy")
        #: program-usage flags for plan_fragment(): the fixed-shape
        #: programs actually run (prefill groups are recorded below)
        self._plan_step = False
        self._plan_verify = False
        self._plan_copy = False

        # speculative decoding ----------------------------------------
        self._drafter = None
        if self.spec_k:
            corpus = ((lambda: self._prefix.iter_sequences())
                      if self._prefix is not None else None)
            self._drafter = build_drafter(
                drafter, k=self.spec_k, cfg=cfg, draft_params=draft_params,
                draft_cfg=draft_cfg, draft_window=draft_window, ngram=ngram,
                corpus=corpus, device=self.device)
            W = self.spec_k + 1
            # verify inputs: tokens (S, W), lengths, widths, table
            self._vh_ctrl = np.zeros((S * (W + 2 + P),), np.int32)
            self._vd_ctrl = torch.zeros((S * (W + 2 + P),),
                                        dtype=torch.int32, device=dev)
            self._v_out = torch.zeros((S, W), dtype=torch.int32, device=dev)

        # the step's captured graphs (CUDA) or eager shapes run (CPU) --
        #: capture the steps as CUDA graphs (always on a CUDA device);
        #: chip_smoke.py clears it to compare the eager step on the card
        self._capture = self.device.type == "cuda"
        self._graphs: dict = {}
        self._graph_pool = None
        self._eager_shapes: set = set()

        # counters ------------------------------------------------------
        self._prefill_token_count = 0
        #: (batch bucket, prompt bucket) of every cold prefill group and
        #: (batch bucket, cached-page bucket, tail bucket) of every warm one
        self._prefill_groups: set = set()
        self._prefill_ctx_groups: set = set()
        self._preemptions = 0
        #: wall seconds of recent dispatches, through the token copy to
        #: the host (each covers `horizon` token steps, or one verify)
        self.step_seconds: deque = deque(maxlen=4096)

        # queueing / lifecycle ----------------------------------------
        self._cond = threading.Condition()
        self._waiting: deque = deque()  # GenerationStreams not yet admitted
        self._closed = False
        self._peak_pages = 0
        self._thread: Optional[threading.Thread] = None
        self.label = name if name is not None else f"d{next(_loop_seq)}"
        self._register_metrics()
        if start:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name=f"decode-loop-{self.label}")
            self._thread.start()

    def _register_metrics(self) -> None:
        """The loop's telemetry series (the JAX loop's names, help
        strings and labels); each counter mirrors one `_Counts` key."""
        reg = telemetry.get_registry()
        lab = {"loop": self.label}

        def counter(name, help_):
            return reg.counter(name, help_).labels(**lab)

        self._counts = _Counts({
            "requests": counter(
                "dl4j_decode_requests",
                "generate requests submitted to the slot scheduler"),
            "tokens_streamed": counter(
                "dl4j_decode_tokens_streamed",
                "tokens emitted onto generation streams"),
            "shed": counter(
                "dl4j_decode_shed",
                "generate requests rejected at submit because the "
                "admission queue was at max_waiting"),
            "deadline_exceeded": counter(
                "dl4j_decode_deadline_exceeded",
                "generate requests shed at submit/admission, or reaped "
                "mid-flight, because their deadline budget was spent"),
            "cancelled": counter(
                "dl4j_decode_cancelled",
                "generate requests cancelled (client disconnect or "
                "GenerationStream.cancel) — slot retired, pages freed"),
            "admission_waits": counter(
                "dl4j_decode_admission_waits",
                "scheduler passes where a queued request could not be "
                "admitted for lack of free pages or slots"),
            "dispatches": counter(
                "dl4j_decode_steps",
                "compiled decode dispatches run (each covers `horizon` "
                "token steps)"),
        })
        self._prefix_counts = _Counts({
            "hits": counter(
                "dl4j_kv_prefix_hits",
                "admissions whose prompt matched >= 1 cached prefix chunk "
                "(shared pool pages mapped by reference)"),
            "misses": counter(
                "dl4j_kv_prefix_misses",
                "cache-eligible admissions that matched no cached chunk "
                "(full cold prefill)"),
            "forks": counter(
                "dl4j_kv_prefix_forks",
                "copy-on-write page forks (decode cursor entered a shared "
                "page; it was duplicated into a private one)"),
            "evictions": counter(
                "dl4j_kv_prefix_evictions",
                "unreferenced cached prefix pages evicted (LRU) to "
                "satisfy an allocation under page pressure"),
        })
        self._spec_counts = _Counts({
            "proposed": counter(
                "dl4j_spec_proposed",
                "draft tokens proposed to speculative verify rounds"),
            "accepted": counter(
                "dl4j_spec_accepted",
                "draft tokens the target model's verify accepted (each "
                "one a decode dispatch saved)"),
            "rounds": counter(
                "dl4j_spec_rounds",
                "widened verify dispatches run (speculative rounds; plain "
                "fallback rounds when no slot had a draft are not counted "
                "here)"),
        })
        tscope = {"scope": f"loop:{self.label}"}
        tier_req = reg.counter(
            "dl4j_tier_requests",
            "generate requests submitted per SLO tier (interactive "
            "goes ahead at admission; batch rides the weighted-fair "
            "bulk lane)")
        self._tier_requests = _Counts(
            {t: tier_req.labels(tier=t, **tscope) for t in TIERS})
        tier_shed = reg.counter(
            "dl4j_tier_shed",
            "generate requests shed at submit per SLO tier (batch "
            "sheds first, at its own lower batch_max_waiting bound)")
        self._tier_shed = _Counts(
            {t: tier_shed.labels(tier=t, **tscope) for t in TIERS})
        self._m_preempt = reg.counter(
            "dl4j_tier_preemptions",
            "batch decode slots preempted for a blocked interactive "
            "admission (lossless: the row resumes via the router's "
            "durable-stream record)").labels(tier=TIER_BATCH, **tscope)
        kv_read = reg.counter(
            "dl4j_decode_kv_read_bytes",
            "KV bytes the decode attention read must touch, summed "
            "over token steps: path=\"kernel\" is the streamed-pages "
            "figure (written pages only — what the pallas lane reads), "
            "path=\"gather\" the dense-window figure (the full "
            "S x max_len reservation); their ratio is the paged "
            "kernel's traffic win")
        #: KV bytes the decode attention read must touch, summed over
        #: token steps: "kernel" = written pages, "gather" = the dense
        #: window (decode_read_bytes)
        self._kv_read = _Counts(
            {path: kv_read.labels(path=path, **lab)
             for path in ("kernel", "gather")})
        self._m_step_s = reg.histogram(
            "dl4j_decode_step_seconds",
            "wall time of one compiled decode dispatch (covers "
            "`horizon` token steps), dispatch through the token D2H "
            "sync").labels(**lab)
        reg.gauge("dl4j_kv_pages_total",
                  "usable KV pages in the block pool").labels(**lab).set(
                      self.n_pages)
        ref = weakref.ref(self)

        def live(attr, empty=0):
            return lambda: (lambda o: getattr(o, attr) if o else empty)(
                ref())

        reg.gauge("dl4j_kv_pages_in_use",
                  "KV pages currently held by in-flight requests"
                  ).labels(**lab).set_function(live("pages_in_use"))
        reg.gauge("dl4j_kv_pages_shared",
                  "KV pages an in-flight slot may not write without a CoW "
                  "fork (>= 2 readers, or referenced while cache-retained)"
                  ).labels(**lab).set_function(live("pages_shared"))
        reg.gauge("dl4j_kv_pages_cached",
                  "KV pages retained by the prefix index (the "
                  "unreferenced ones form the LRU-evictable tier)"
                  ).labels(**lab).set_function(live("pages_cached"))
        reg.gauge("dl4j_decode_active_slots",
                  "slots holding an in-flight request"
                  ).labels(**lab).set_function(live("occupied_slots"))
        backlog = reg.gauge(
            "dl4j_tier_backlog",
            "generate requests queued for admission per SLO tier (the "
            "batch figure is the signal the autoscaler and the "
            "backlog-derived Retry-After key on)")
        for t in TIERS:
            backlog.labels(tier=t, **tscope).set_function(
                (lambda _t: lambda: (lambda o: o._tier_waiting[_t]
                                     if o else 0)(ref()))(t))
        reg.gauge("dl4j_spec_acceptance_rate",
                  "accepted / proposed draft tokens over the loop's "
                  "lifetime (0.0 while speculation is off or nothing was "
                  "proposed)").labels(**lab).set_function(
                      live("spec_acceptance_rate", 0.0))

    def _observe_step(self, seconds: float) -> None:
        self.step_seconds.append(seconds)
        self._m_step_s.observe(seconds)

    @staticmethod
    def _ctrl_views(buf, s: int, p: int):
        """(tokens (S,), lengths (S,), stop (S,), table (S, P)) views of
        one flat control buffer, numpy or torch."""
        return (buf[:s], buf[s:2 * s], buf[2 * s:3 * s],
                buf[3 * s:].reshape(s, p))

    def _verify_views(self, buf):
        """(tokens (S, W), lengths (S,), widths (S,), table (S, P)) views
        of the flat verify buffer, numpy or torch."""
        s, w, p = self.slots, self.spec_k + 1, self._pps
        return (buf[:s * w].reshape(s, w), buf[s * w:s * w + s],
                buf[s * w + s:s * w + 2 * s],
                buf[s * (w + 2):].reshape(s, p))

    # ----------------------------------------------------- public API
    @staticmethod
    def _per_row(value, n_rows: int, name: str) -> List[int]:
        """A scalar-or-per-row int parameter as one int per row."""
        if isinstance(value, (list, tuple, np.ndarray)):
            if len(value) != n_rows:
                raise ValueError(f"per-row {name} needs {n_rows} entries, "
                                 f"got {len(value)}")
            return [int(v) for v in value]
        return [int(value)] * n_rows

    def validate(self, prompt, max_tokens: int) -> np.ndarray:
        """Check one request without enqueueing it (raises ValueError);
        returns the normalized 1-D prompt."""
        prompt = np.asarray(prompt).ravel().astype(np.int64)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        if prompt.size + max_tokens > self.cfg.max_len:
            raise ValueError(
                f"generation would exceed max_len ({prompt.size} prompt "
                f"+ {max_tokens} new > {self.cfg.max_len})")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            raise ValueError(f"prompt token ids must be in "
                             f"[0, {self.cfg.vocab_size})")
        need = pages_for_tokens(int(prompt.size) + 1, self.page_size)
        if need > self.n_pages:
            raise ValueError(
                f"prompt needs {need} pages but the pool only has "
                f"{self.n_pages}")
        return prompt

    def submit(self, prompt, max_tokens: int, eos_id: Optional[int] = None,
               deadline: Optional[Deadline] = None,
               prefix_cache: bool = True, speculation: bool = True,
               tier: str = TIER_INTERACTIVE) -> GenerationStream:
        """Queue one prompt (1-D int sequence). The stream's first token
        arrives after admission + prefill; termination on EOS (when
        given), `max_tokens`, cancellation or the deadline.
        `prefix_cache=False` neither reuses nor seeds the prefix cache;
        `speculation=False` opts out of drafting; `tier="batch"` rides
        the preemptible bulk lane."""
        return self.submit_many([prompt], max_tokens, eos_id,
                                deadline=deadline, prefix_cache=prefix_cache,
                                speculation=speculation, tier=tier)[0]

    def submit_many(self, prompts, max_tokens, eos_id: Optional[int] = None,
                    deadline: Optional[Deadline] = None,
                    prefix_cache: bool = True, token_index_base=0,
                    speculation: bool = True,
                    tier: str = TIER_INTERACTIVE) -> List[GenerationStream]:
        """Admit several rows as ONE unit: all rows enqueue or none do.
        `max_tokens` and `token_index_base` are one scalar for every row
        or a per-row sequence. `tier` applies to the whole group; a shed
        carries the tier and a Retry-After derived from that tier's
        backlog. A prefill-role loop refuses every stream."""
        if self.role == ROLE_PREFILL:
            raise ValueError(
                "this replica has role 'prefill' — it computes prompt "
                "KV for handoff (/prefill) and serves /kv/export; "
                "generate streams belong on a decode/unified replica")
        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r} (expected one of "
                             f"{TIERS})")
        if deadline is not None and deadline.expired:
            with self._cond:
                self._counts.add("deadline_exceeded")
            deadline.check("decode admission")  # raises
        per_row_max = self._per_row(max_tokens, len(prompts), "max_tokens")
        per_row_base = self._per_row(token_index_base, len(prompts),
                                     "token_index_base")
        for base in per_row_base:
            if base < 0:
                raise ValueError(
                    f"per-row token_index_base must be >= 0, got {base}")
        prompts = [self.validate(p, mt) for p, mt in zip(prompts,
                                                         per_row_max)]
        streams = [GenerationStream(p, mt, eos_id, deadline=deadline)
                   for p, mt in zip(prompts, per_row_max)]
        loop_ref = weakref.ref(self)
        for stream, base in zip(streams, per_row_base):
            stream._loop_ref = loop_ref
            stream.prefix_cache = bool(prefix_cache)
            stream.speculation = bool(speculation)
            stream.token_index_base = base
            stream.tier = tier
        with self._cond:
            if self._closed:
                raise RuntimeError("decode loop is closed")
            bound = (self.batch_max_waiting if tier == TIER_BATCH
                     else self.max_waiting)
            if bound is not None:
                # a group that could start right now is never rejected
                need = sum(pages_for_tokens(p.size + 1, self.page_size)
                           for p in prompts)
                free_slots = sum(1 for s in self._slot_state if s is None)
                can_now = (not self._waiting
                           and self._avail_pages() >= need
                           and free_slots >= len(prompts))
                tier_q = self._tier_waiting[tier]
                if not can_now and tier_q + len(prompts) > bound:
                    self._counts.add("shed")
                    self._tier_shed.add(tier)
                    raise OverloadedError(
                        f"decode admission queue full for tier {tier!r} "
                        f"({tier_q} waiting, "
                        f"{len(self._free)}/{self.n_pages} pages free)",
                        retry_after_ms=backlog_retry_ms(
                            tier_q + len(prompts), _TIER_ITEM_MS[tier]),
                        tier=tier)
            self._counts.add("requests", len(streams))
            self._tier_requests.add(tier, len(streams))
            self._waiting.extend(streams)
            self._tier_waiting[tier] += len(streams)
            self._cond.notify_all()
        return streams

    def generate(self, prompt, max_tokens: int,
                 eos_id: Optional[int] = None,
                 timeout: Optional[float] = 120.0) -> List[int]:
        """Blocking convenience: submit + wait, returns prompt+generated."""
        return self.submit(prompt, max_tokens, eos_id).full_sequence(timeout)

    @property
    def pages_in_use(self) -> int:
        """Pages held by in-flight requests (refcount > 0); cached but
        unreferenced pages are not in use."""
        return int(np.count_nonzero(self._ref))

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_cached(self) -> int:
        """Pages retained by the prefix index."""
        return 0 if self._prefix is None else len(self._prefix)

    @property
    def pages_shared(self) -> int:
        """Pages an in-flight slot may not write in place: >= 2 readers,
        or >= 1 reader while the cache retains the page."""
        shared = int(np.count_nonzero(self._ref >= 2))
        if self._prefix is not None:
            shared += sum(1 for p in self._prefix.pages()
                          if self._ref[p] == 1)
        return shared

    def _cached_unref(self) -> int:
        """The evictable LRU tier: cache-retained pages no slot reads."""
        if self._prefix is None:
            return 0
        return sum(1 for p in self._prefix.pages() if self._ref[p] == 0)

    def _avail_pages(self) -> int:
        """Pages an allocation could obtain now: free + evictable."""
        return len(self._free) + self._cached_unref()

    def _alloc_page(self) -> Optional[int]:
        """Take one page for a new reader (ref -> 1): from the free list,
        else by LRU-evicting an unreferenced cached page. None when
        neither has one (callers stall)."""
        if self._free:
            page = self._free.popleft()
        elif self._prefix is not None:
            page = self._prefix.evict_lru(lambda p: self._ref[p] == 0)
            if page is not None:
                self._prefix_counts.add("evictions")
        else:
            page = None
        if page is not None:
            self._ref[page] += 1
        return page

    def _release_page(self, page: int) -> None:
        """Drop one reader; the page returns to the free list only when
        the last reader is gone and the cache does not retain it."""
        self._ref[page] -= 1
        if self._ref[page] < 0:
            raise AssertionError(f"page {page} refcount underflow")
        if self._ref[page] == 0 and (self._prefix is None
                                     or not self._prefix.owns(page)):
            self._free.append(page)

    def _is_shared(self, page: int) -> bool:
        """True when a slot must copy-on-write fork before writing."""
        return (self._ref[page] > 1
                or (self._prefix is not None and self._prefix.owns(page)))

    @property
    def occupied_slots(self) -> int:
        return sum(1 for s in self._slot_state if s is not None)

    @property
    def load(self) -> int:
        """Live in-flight pressure: queued + occupied slots (the replica
        set's least-loaded selector keys on it)."""
        with self._cond:
            return len(self._waiting) + self.occupied_slots

    @property
    def alive(self) -> bool:
        """Scheduler thread running."""
        return (self._thread is not None and self._thread.is_alive()
                and not self._closed)

    @property
    def spec_acceptance_rate(self) -> float:
        """Accepted / proposed draft tokens over the loop's lifetime (0.0
        while nothing was proposed)."""
        proposed = self._spec_counts["proposed"]
        return self._spec_counts["accepted"] / proposed if proposed else 0.0

    def kv_pool_bytes(self) -> int:
        return paged_kv_bytes(self.cfg, self.n_pages, self.page_size)

    def decode_step_programs(self) -> int:
        """The decode lane's program count: the captured CUDA graphs on
        the card (1 plain; step + verify = 2 with speculation), the
        distinct step shapes run on the CPU."""
        return len(self._graphs) if self._capture else len(
            self._eager_shapes)

    def prefill_programs(self) -> int:
        """Distinct cold prefill group shapes run (bounded by the bucket
        ladder)."""
        return len(self._prefill_groups)

    def prefill_ctx_programs(self) -> int:
        """Distinct warm-tail prefill group shapes run (prefix cache
        hits with a tail to prefill)."""
        return len(self._prefill_ctx_groups)

    def graph_launches(self) -> dict:
        """Kernel launches made by graph replays since construction, per
        kernel: replays x the launches recorded in each graph. The
        wrappers' own `launches` counters never see them."""
        with self._cond:  # the scheduler thread adds graphs
            graphs = list(self._graphs.values())
        return {name: sum(g.replays * g.launches[name] for g in graphs)
                for name in _CAPTURED_LAUNCHES}

    # ---- warmup plans (compilecache/warmup.py, the JAX package's format)
    def plan_fragment(self) -> dict:
        """The "decode" fragment of a warmup plan: which of this loop's
        programs ran and at which prefill group shapes. Fixed-shape
        programs (step, verify, copy) are flags — their shapes follow
        from the loop's config; only the prefill groups depend on the
        traffic."""
        frag = {
            "cache_key": self.cache_key,
            "role": self.role,
            "step": self._plan_step,
            "verify": self._plan_verify,
            "copy": self._plan_copy,
            "prefill": sorted(list(g) for g in self._prefill_groups),
            "prefill_ctx": sorted(list(g)
                                  for g in self._prefill_ctx_groups),
        }
        if (self._drafter is not None
                and getattr(self._drafter, "kind", None) == "model"):
            frag["draft"] = {"rows": self.slots, "k": self.spec_k}
        return frag

    def warm_programs(self, frag: dict, timeout: float = 600.0) -> int:
        """Replay a recorded plan fragment on the scheduler thread: run
        every recorded prefill group on pad rows (their writes go to the
        trash page), fork the trash page onto itself if the copy ran,
        capture the step and verify graphs (on the card; on the CPU one
        idle eager step each) and warm the model drafter — all before the
        caller flips `/readyz`. A fragment of another loop identity is
        ignored. Returns the number of programs warmed."""
        if frag.get("cache_key") != self.cache_key:
            return 0
        job = {"kind": "warm", "frag": frag, "event": threading.Event(),
               "result": {}}
        self._enqueue_kv_job(job, timeout, "warmup plan replay did not "
                                           "complete")
        err = job["result"].get("error")
        if err is not None:
            raise err
        return int(job["result"]["warmed"])

    def _warm_program(self, name: str) -> None:
        """Build the step or verify program as its first dispatch would:
        the graph capture on the card (its warm-up run writes only the
        trash page), one idle eager run on the CPU."""
        if self._capture:
            self._ensure_graph(name)
            dispatcher = self._step if name == "step" else self._verify
            if dispatcher is not None:
                dispatcher.warm()
        else:
            (self._idle_step if name == "step" else self._idle_verify)()
            self._program(name)

    def _apply_warm(self, frag: dict) -> int:
        """Scheduler-thread half of `warm_programs`."""
        S, ps, trash = self.slots, self.page_size, self._trash
        n = 0
        if frag.get("step"):
            self._warm_program("step")
            self._plan_step = True
            n += 1
        if frag.get("verify") and self.spec_k:
            self._warm_program("verify")
            self._plan_verify = True
            n += 1
        if frag.get("copy"):
            self._program("copy", trash, trash)
            self._plan_copy = True
            n += 1
        for bb, tb in frag.get("prefill", ()):
            self._prefill_groups.add((int(bb), int(tb)))
            self._program(
                "prefill",
                self._to_device(np.zeros((bb, tb), np.int32)),
                self._to_device(np.ones((bb,), np.int32)),
                self._to_device(np.full((bb, tb // ps), trash, np.int32)))
            n += 1
        for bb, cb, tb in frag.get("prefill_ctx", ()):
            self._prefill_ctx_groups.add((int(bb), int(cb), int(tb)))
            self._program(
                "prefill_ctx",
                self._to_device(np.zeros((bb, tb), np.int32)),
                self._to_device(np.ones((bb,), np.int32)),
                self._to_device(np.full((bb, tb // ps), trash, np.int32)),
                self._to_device(np.full((bb, cb), trash, np.int32)),
                self._to_device(np.zeros((bb,), np.int32)))
            n += 1
        draft = frag.get("draft")
        if (draft and self._drafter is not None
                and hasattr(self._drafter, "warm")):
            n += int(self._drafter.warm(int(draft.get("rows", S)),
                                        int(draft.get("k", self.spec_k))))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return n

    # ---- fleet KV plane (serving/fleetkv.py)
    def kv_summary(self) -> Optional[dict]:
        """The affinity summary piggybacked on /readyz: cumulative
        head-chunk fingerprints of every cached trie path (most recent
        first, capped), plus the cache and ship counters. None while the
        plane is off. Only tokens the trie retains are fingerprinted;
        opted-out requests never seeded it."""
        if self._prefix is None or self.fleet_kv == fleetkv.MODE_OFF:
            return None
        # chaos: a summary-build fault must degrade the replica to "no
        # affinity signal", never fail the health probe
        chaos.hit("fleet.kv_summary")
        with self._cond:
            return {
                "v": 1,
                "mode": self.fleet_kv,
                "role": self.role,
                "page_size": self.page_size,
                "heads": fleetkv.summary_heads(self._prefix,
                                               self.page_size),
                "pages_cached": self.pages_cached,
                "hits": self._prefix_counts["hits"],
                "misses": self._prefix_counts["misses"],
                **self._ship_stats,
            }

    def kv_export(self, tokens: Sequence[int],
                  max_chunks: Optional[int] = None) -> Optional[bytes]:
        """Donor half of a page ship: serialize this replica's cached
        pages covering `tokens`' head chunks (crc-framed, no pickle —
        fleetkv.pack_pages). None when shipping is off. Runs on the HTTP
        handler thread; only the bookkeeping takes the lock.

        The matched pages are PINNED (reader refcount) for the read:
        eviction takes only refcount-zero pages, and a writer forks away
        from a trie-retained page, so no one writes them while they are
        read. Their bytes were written on the scheduler thread's stream;
        the read waits on the CUDA event recorded after the last such
        write (`_pool_event`) instead of going through the kv job queue,
        so an export never waits for a decode tick and the scheduler
        never blocks on a device-to-host copy it does not need. The
        matched pages of every layer are gathered with one
        `index_select` per tensor and brought to the host in ONE copy
        (`paged_kv.extract_pages`)."""
        if self._prefix is None or self.fleet_kv != fleetkv.MODE_ON:
            return None
        with self._cond:
            matched = self._prefix.match(tokens)
            if max_chunks is not None:
                matched = matched[:int(max_chunks)]
            for page in matched:
                self._ref[page] += 1  # pin across the export read
            written = self._pool_event
        try:
            # chaos: donor faults mid-ship (a "hang" rule holds the pins
            # open — the export-vs-eviction drills ride this window)
            chaos.hit("fleet.kv_ship", role="export", chunks=len(matched))
            if written is not None:
                torch.cuda.current_stream(self.device).wait_event(written)
            chunks = extract_pages(self._pool, matched)
        finally:
            with self._cond:
                for page in matched:
                    self._release_page(page)
                self._cond.notify_all()
        meta = {
            "v": 1,
            "cache_key": self.cache_key,
            "page_size": self.page_size,
            "chunks": len(matched),
            "layers": self.cfg.n_layers,
            "shape": [self.cfg.n_heads, self.page_size,
                      self.cfg.d_model // self.cfg.n_heads],
        }
        return fleetkv.pack_pages(meta, chunks)

    def kv_ship(self, donor_url: str, tokens: Sequence[int],
                timeout: Optional[float] = None) -> int:
        """Receiver half: fetch the donor's cached pages for `tokens`'
        head chunks and install whatever this trie is missing. Returns
        the number of pages installed; 0 on ANY failure (transport,
        framing, crc, identity, pool pressure, chaos) — the caller's
        admission prefills the same tokens regardless. Safe from any
        thread: the install runs on the scheduler thread (`_kv_jobs`)."""
        if self._prefix is None or self.fleet_kv != fleetkv.MODE_ON:
            return 0
        n_full = len(tokens) // self.page_size
        if n_full == 0 or not donor_url:
            return 0
        with self._cond:
            covered = len(self._prefix.match(tokens))
        if covered >= n_full:
            return 0  # already warm locally — nothing worth a fetch
        if timeout is None:
            timeout = self.kv_ship_timeout
        try:
            # chaos: receiver-side fetch faults (transport flakes)
            chaos.hit("fleet.kv_ship", role="fetch", donor=donor_url)
            payload = fleetkv.fetch_pages(
                donor_url, tokens[:n_full * self.page_size], timeout,
                max_chunks=n_full)
            header, chunks = fleetkv.unpack_pages(payload)
            if header.get("cache_key") != self.cache_key:
                raise fleetkv.ShipError(
                    "donor/receiver decode identity mismatch — "
                    "refusing pages from a different model, page "
                    "size, kernel lane, or device")
            if not chunks:
                raise fleetkv.ShipError("donor had no cached pages")
            installed = self._kv_install(tokens, chunks, timeout)
        except Exception:
            with self._cond:
                self._ship_stats["ship_failures"] += 1
            return 0
        if installed:
            with self._cond:
                self._ship_stats["page_ships"] += installed
                self._ship_stats["ship_bytes"] += len(payload)
        return installed

    def _kv_install(self, tokens, chunks, timeout: float) -> int:
        """Hand an install to the scheduler thread and wait for it."""
        job = {"tokens": list(tokens), "chunks": chunks,
               "event": threading.Event(), "result": {}}
        self._enqueue_kv_job(job, timeout, "install did not complete "
                                           "within the ship budget")
        err = job["result"].get("error")
        if err is not None:
            raise err
        return int(job["result"].get("installed", 0))

    def _enqueue_kv_job(self, job: dict, timeout: float,
                        expiry_msg: str) -> None:
        """Route one pool-writing job through the scheduler thread (or
        run it inline with no scheduler running) and wait it out."""
        if self.alive:
            with self._cond:
                if self._closed:
                    job["result"]["error"] = RuntimeError(
                        "decode loop is closed")
                    return
                self._kv_jobs.append(job)
                self._cond.notify_all()
            if not job["event"].wait(timeout=max(1.0, float(timeout))):
                job["result"].setdefault(
                    "error", fleetkv.ShipError(expiry_msg))
        else:
            self._run_kv_job(job)

    def prefill_only(self, tokens: Sequence[int],
                     timeout: Optional[float] = None) -> dict:
        """Handoff source: compute KV for `tokens`' FULL page-aligned
        head chunks into this replica's pool and adopt the pages into the
        prefix trie as cached pages — where `/kv/export` reads from —
        without starting a stream or dispatching a decode step. A fully
        covered head is a cheap no-op. Raises on pool pressure or chaos
        faults (the router then falls back to plain prefill on the
        decode replica). Returns {"chunks", "covered", "cached",
        "kv_bytes"}."""
        if self._prefix is None:
            raise ValueError(
                "prefill_only needs the prefix cache: the trie is "
                "where handoff pages live until /kv/export ships them")
        n_full = len(tokens) // self.page_size
        if n_full == 0:
            # sub-page prompts have no trie key — nothing to hand off
            return {"chunks": 0, "covered": 0, "cached": 0,
                    "kv_bytes": 0}
        job = {"kind": "prefill", "tokens": [int(t) for t in tokens],
               "event": threading.Event(), "result": {}}
        if timeout is None:
            timeout = max(30.0, self.kv_ship_timeout)
        self._enqueue_kv_job(job, timeout, "prefill handoff did not "
                                           "complete within its budget")
        err = job["result"].get("error")
        if err is not None:
            raise err
        return job["result"]["report"]

    def _apply_prefill_only(self, tokens) -> dict:
        """Scheduler-thread half of `prefill_only`: pin the cached head
        run, allocate pages for the uncovered chunks, run the same
        bucketed prefill admission uses (batch 1), adopt the pages into
        the trie, release every pin — the page invariant holds at every
        exit."""
        ps = self.page_size
        head = [int(t) for t in tokens[:(len(tokens) // ps) * ps]]
        n_full = len(head) // ps
        # chaos: a handoff fault on the export side
        chaos.hit("disagg.handoff", role="export", chunks=n_full)
        with self._cond:
            matched = self._prefix.match(head)
            covered = len(matched)
            need = n_full - covered
            page_bytes = paged_kv_bytes(self.cfg, 1, self.page_size)
            if need <= 0:
                return {"chunks": n_full, "covered": covered,
                        "cached": 0, "kv_bytes": n_full * page_bytes}
            for page in matched:
                self._ref[page] += 1
            fresh: List[int] = []
            if self._avail_pages() >= need:
                for _ in range(need):
                    fresh.append(self._alloc_page())
        try:
            if len(fresh) < need:
                raise OverloadedError(
                    f"prefill handoff needs {need} pages but the pool "
                    f"has no headroom "
                    f"({len(self._free)}/{self.n_pages} free)",
                    retry_after_ms=1000)
            cov_tok = covered * ps
            tl = len(head) - cov_tok
            tb = next(b for b in self._buckets if b >= tl)
            padded = np.zeros((1, tb), np.int32)
            padded[0, :tl] = head[cov_tok:]
            lens = np.full((1,), tl, np.int32)
            pids = np.full((1, tb // ps), self._trash, np.int32)
            pids[0, :len(fresh)] = fresh
            if covered == 0:
                self._prefill_groups.add((1, tb))
                self._program("prefill", self._to_device(padded),
                              self._to_device(lens), self._to_device(pids))
            else:
                cb = min(_pow2(covered), self._pps)
                ctab = np.full((1, cb), self._trash, np.int32)
                ctab[0, :covered] = matched
                clen = np.full((1,), cov_tok, np.int32)
                self._prefill_ctx_groups.add((1, cb, tb))
                self._program(
                    "prefill_ctx",
                    self._to_device(padded), self._to_device(lens),
                    self._to_device(pids), self._to_device(ctab),
                    self._to_device(clen))
            self._mark_pool_written()
            self._prefill_token_count += tl
            with self._cond:
                adopted = self._prefix.insert(head, matched + fresh)
                self._ship_stats["prefill_handoffs"] = (
                    self._ship_stats.get("prefill_handoffs", 0) + 1)
            return {"chunks": n_full, "covered": covered,
                    "cached": adopted, "kv_bytes": n_full * page_bytes}
        finally:
            with self._cond:
                for page in matched + fresh:
                    self._release_page(page)
                self._cond.notify_all()

    def _mark_pool_written(self) -> None:
        """Record, on the scheduler thread's stream, the event an export
        read on another thread waits on before reading pool pages."""
        if self.device.type != "cuda":
            return
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        with self._cond:
            self._pool_event = event

    def _service_kv_jobs(self) -> None:
        """Scheduler-thread drain of queued kv jobs — at the top of every
        tick, before admission, so an install that lands between ticks
        warms the very next `_admit` match."""
        while True:
            with self._cond:
                if not self._kv_jobs:
                    return
                job = self._kv_jobs.popleft()
            self._run_kv_job(job)

    def load_params(self, params) -> None:
        """Hot reload: copy new weights (the same structure, shapes and
        dtypes) into the loop's params IN PLACE, on the scheduler thread
        between dispatches — the captured graphs read the params'
        storage, so they are never rebound. A dispatch sees all old or
        all new weights."""
        job = {"kind": "params", "params": params,
               "event": threading.Event(), "result": {}}
        self._enqueue_kv_job(job, 60.0, "params reload did not complete")
        err = job["result"].get("error")
        if err is not None:
            raise err

    def _run_kv_job(self, job: dict) -> None:
        try:
            if job.get("kind") == "params":
                _copy_params(self.params, job["params"])
            elif job.get("kind") == "prefill":
                job["result"]["report"] = self._apply_prefill_only(
                    job["tokens"])
            elif job.get("kind") == "warm":
                job["result"]["warmed"] = self._apply_warm(job["frag"])
            else:
                job["result"]["installed"] = self._kv_apply_install(
                    job["tokens"], job["chunks"])
        except Exception as e:
            job["result"]["error"] = e
        finally:
            job["event"].set()

    def _drain_kv_jobs(self, exc: BaseException) -> None:
        with self._cond:
            while self._kv_jobs:
                job = self._kv_jobs.popleft()
                job["result"]["error"] = exc
                job["event"].set()

    def _kv_apply_install(self, tokens, chunks) -> int:
        """Install shipped chunk K/V beyond this trie's coverage: pin the
        matched path (an eviction during our own allocations must not
        take it), allocate fresh pages (free list first, LRU eviction
        second), write the bytes in place (`install_pages`), adopt the
        pages into the trie, drop every pin — adopted pages land in the
        cached tier like a retired prompt's. Runs on the scheduler
        thread."""
        ps = self.page_size
        with self._cond:
            matched = self._prefix.match(tokens)
            covered = len(matched)
            depth = min(len(chunks), len(tokens) // ps)
            if depth <= covered:
                return 0
            need = depth - covered
            for page in matched:
                self._ref[page] += 1
            fresh: List[int] = []
            if self._avail_pages() >= need:
                for _ in range(need):
                    fresh.append(self._alloc_page())
        try:
            if len(fresh) < need:
                raise fleetkv.ShipError(
                    "pool has no headroom for shipped pages")
            install_pages(self._pool, fresh, chunks[covered:depth])
            self._mark_pool_written()
            with self._cond:
                adopted = self._prefix.insert(
                    tokens[:depth * ps], matched + fresh)
            return adopted
        finally:
            with self._cond:
                for page in matched + fresh:
                    self._release_page(page)
                self._cond.notify_all()

    def snapshot(self) -> dict:
        with self._cond:
            return {
                "role": self.role,
                "device": str(self.device),
                "slots": self.slots,
                "occupied_slots": self.occupied_slots,
                "queued": len(self._waiting),
                "page_size": self.page_size,
                "horizon": self.horizon,
                "pages_total": self.n_pages,
                "pages_in_use": self.pages_in_use,
                "pages_free": self.pages_free,
                "peak_pages_in_use": self._peak_pages,
                "pool_bytes": self.kv_pool_bytes(),
                "max_waiting": self.max_waiting,
                "tiers": {
                    "batch_share": self.batch_share,
                    "batch_slot_cap": self._batch_slot_cap,
                    "batch_max_waiting": self.batch_max_waiting,
                    "preemptions": self._preemptions,
                    "waiting": dict(self._tier_waiting),
                    "occupied": {
                        t: sum(1 for s in self._slot_state
                               if s is not None and s.stream.tier == t)
                        for t in TIERS},
                    "requests": dict(self._tier_requests),
                    "shed": dict(self._tier_shed),
                },
                **self._counts,
                "decode_kernel": {"requested": self.kernel_requested,
                                  "selected": self.decode_kernel,
                                  "kv_read_bytes": dict(self._kv_read)},
                "decode_step_programs": self.decode_step_programs(),
                "decode_graphs": {
                    "captured": sorted(self._graphs),
                    "replays": {n: g.replays
                                for n, g in self._graphs.items()},
                    "capture_ms": {n: g.capture_ms
                                   for n, g in self._graphs.items()},
                    "kernel_launches": self.graph_launches(),
                },
                "prefill_programs": self.prefill_programs(),
                "prefill_ctx_programs": len(self._prefill_ctx_groups),
                "prefill_groups": sorted(self._prefill_groups),
                "prefill_tokens": self._prefill_token_count,
                "prefix_cache": {
                    "enabled": self.prefix_cache_enabled,
                    **self._prefix_counts,
                    "pages_cached": self.pages_cached,
                    "pages_shared": self.pages_shared,
                    "cached_unreferenced": self._cached_unref(),
                    "nodes": self.pages_cached,
                },
                "fleet_kv": {"mode": self.fleet_kv, **self._ship_stats},
                "speculation": {
                    "enabled": bool(self.spec_k),
                    "k": self.spec_k,
                    "drafter": (None if self._drafter is None
                                else self._drafter.kind),
                    **self._spec_counts,
                    "acceptance_rate": self.spec_acceptance_rate,
                    "draft_programs": (
                        self._drafter.draft_programs()
                        if hasattr(self._drafter, "draft_programs") else 0),
                },
            }

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting new requests, drain everything queued and in
        flight, stop the scheduler thread."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def __enter__(self) -> "DecodeLoop":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------ scheduler
    def _run(self) -> None:
        while True:
            with self._cond:
                while (not self._closed and not self._waiting
                       and not self._kv_jobs
                       and self.occupied_slots == 0):
                    self._cond.wait(timeout=0.1)
                if (self._closed and not self._waiting
                        and self.occupied_slots == 0):
                    self._drain_kv_jobs(RuntimeError("decode loop closed"))
                    return
            try:
                self.tick()
            except Exception as e:
                # a scheduler crash fails the in-flight and queued streams
                # loudly (their result() raises it) instead of hanging them
                self._fail_all(e)
                return

    def _fail_all(self, exc: BaseException) -> None:
        self._drain_kv_jobs(exc)
        with self._cond:
            self._deferred = []
            for i, slot in enumerate(self._slot_state):
                if slot is not None:
                    for page in slot.pages:
                        self._release_page(page)
                    slot.stream._finish("error", exc)
                    self._slot_state[i] = None
            while self._waiting:
                stream = self._waiting.popleft()
                self._tier_waiting[stream.tier] -= 1
                stream._finish("error", exc)
            self._dirty = True

    def tick(self) -> bool:
        """One scheduler pass: reap, admit what fits, grant boundary
        pages, run one dispatch if any slot can advance, emit tokens,
        retire finished slots. Returns True if a dispatch ran. Public so
        tests (and `start=False` callers) can drive the loop."""
        self._reap()
        # shipped-page installs and handoff prefills land before
        # admission, so the very next `_admit` match sees them
        self._service_kv_jobs()
        # chaos: a "delay" rule paces every scheduler pass; an "error"
        # drills the fail-loudly path in _run
        chaos.hit("decode.step")
        self._admit()
        ran = self._dispatch_spec() if self.spec_k else \
            self._dispatch_plain()
        if not ran:
            # no dispatch ran (e.g. every admitted request has
            # max_tokens=1): deferred prefill tokens still must reach
            # their streams
            self._flush_first_tokens()
            with self._cond:
                stuck = (self.occupied_slots > 0
                         and self._avail_pages() == 0
                         and all(s is None
                                 or self._stop[i] <= self._lengths[i]
                                 for i, s in enumerate(self._slot_state)))
            if stuck:
                self._fail_all(RuntimeError(
                    "KV page pool exhausted with every slot stalled — no "
                    "completion can free a page; size the pool with "
                    "paged_kv_bytes"))
        return ran

    def run_until_idle(self, max_ticks: int = 100_000) -> None:
        """Drive the loop inline until nothing is queued or in flight
        (`start=False` mode / tests)."""
        for _ in range(max_ticks):
            with self._cond:
                if not self._waiting and self.occupied_slots == 0:
                    return
            self.tick()
        raise RuntimeError("decode loop did not drain")

    # ---- cancellation / expiry reaping
    def _reap(self) -> None:
        """Retire occupied slots whose stream was cancelled or whose
        deadline ran out mid-flight, within this scheduler pass."""
        with self._cond:
            for i, slot in enumerate(self._slot_state):
                if slot is None:
                    continue
                stream = slot.stream
                if stream.cancelled:
                    self._counts.add("cancelled")
                    self._retire(i, slot, "cancelled")
                elif (stream.deadline is not None
                      and stream.deadline.expired):
                    self._counts.add("deadline_exceeded")
                    self._retire(i, slot, "deadline_exceeded",
                                 error=DeadlineExceededError(
                                     "deadline exceeded mid-generation",
                                     deadline_ms=stream.deadline.budget_ms,
                                     elapsed_ms=stream.deadline
                                     .elapsed_ms()))

    # ---- admission
    def _preempt_one(self, used: set) -> bool:
        """Evict ONE batch slot so a blocked interactive admission can
        proceed: the batch slot with the fewest tokens emitted retires
        with finish_reason "preempted" (its full prompt pages seed the
        prefix cache). Returns True when a victim was retired. Caller
        holds the lock."""
        victim = None
        for i, slot in enumerate(self._slot_state):
            if slot is None or slot.stream.tier != TIER_BATCH:
                continue
            if victim is None or (slot.emitted
                                  < self._slot_state[victim].emitted):
                victim = i
        if victim is None:
            return False
        self._preemptions += 1
        self._m_preempt.inc()
        self._retire(victim, self._slot_state[victim], "preempted")
        used.discard(victim)
        return True

    def _admit(self) -> None:
        ps = self.page_size
        admitted = []  # (slot_idx, stream, pages, plen, covered)
        with self._cond:
            used = {i for i, s in enumerate(self._slot_state)
                    if s is not None}
            batch_held = sum(1 for s in self._slot_state
                             if s is not None and s.stream.tier == TIER_BATCH)
            inter_held = len(used) - batch_held
            while self._waiting:
                # every interactive arrival goes ahead of every batch one
                # (FIFO within a tier)
                stream = next((s for s in self._waiting
                               if s.tier == TIER_INTERACTIVE),
                              self._waiting[0])
                interactive = stream.tier == TIER_INTERACTIVE
                # queue-expired or cancelled work is shed before prefill
                if stream.cancelled:
                    self._waiting.remove(stream)
                    self._tier_waiting[stream.tier] -= 1
                    self._counts.add("cancelled")
                    stream._finish("cancelled")
                    continue
                if stream.deadline is not None and stream.deadline.expired:
                    self._waiting.remove(stream)
                    self._tier_waiting[stream.tier] -= 1
                    self._counts.add("deadline_exceeded")
                    stream._finish(
                        "deadline_exceeded", DeadlineExceededError(
                            "deadline exceeded while queued for a decode "
                            "slot", deadline_ms=stream.deadline.budget_ms,
                            elapsed_ms=stream.deadline.elapsed_ms()))
                    continue
                if (not interactive and batch_held >= self._batch_slot_cap
                        and inter_held > 0):
                    # weighted-fair share while interactive work is live
                    self._counts.add("admission_waits")
                    break
                plen = len(stream.prompt)
                idx = next((i for i in range(self.slots) if i not in used),
                           None)
                while (idx is None and interactive
                       and self._preempt_one(used)):
                    batch_held -= 1
                    idx = next((i for i in range(self.slots)
                                if i not in used), None)
                if idx is None:
                    self._counts.add("admission_waits")
                    break
                # the longest cached run of FULL chunks is mapped by
                # reference; only the uncovered tail is prefilled
                use_cache = self._prefix is not None and stream.prefix_cache
                matched = self._prefix.match(stream.prompt) if use_cache \
                    else []
                covered = len(matched) * ps
                # reference the cached run FIRST, so no eviction below can
                # take the pages this request is about to read
                for page in matched:
                    self._ref[page] += 1
                # uncovered prompt pages + room for the first decode write
                need = pages_for_tokens(plen + 1, ps) - len(matched)
                while (self._avail_pages() < need and interactive
                       and self._preempt_one(used)):
                    batch_held -= 1
                if self._avail_pages() < need:
                    for page in matched:
                        self._release_page(page)
                    self._counts.add("admission_waits")
                    break
                self._waiting.remove(stream)
                self._tier_waiting[stream.tier] -= 1
                if interactive:
                    inter_held += 1
                else:
                    batch_held += 1
                used.add(idx)
                pages = list(matched)
                for _ in range(pages_for_tokens(plen, ps) - len(matched)):
                    page = self._alloc_page()
                    if page is None:
                        raise AssertionError("page allocation failed after "
                                             "the availability check")
                    pages.append(page)
                if use_cache:
                    self._prefix_counts.add("hits" if matched else "misses")
                admitted.append((idx, stream, pages, plen, covered))
            if admitted:
                self._peak_pages = max(self._peak_pages, self.pages_in_use)
        if not admitted:
            return
        cold = [a for a in admitted if a[4] == 0]
        warm = [a for a in admitted if 0 < a[4] < a[3]]
        full = [a for a in admitted if a[4] >= a[3]]
        # fully covered prompts skip prefill: the slot starts one position
        # early with its last prompt token pending, so the first decode
        # dispatch recomputes position plen-1 (its K/V write re-enters the
        # last shared page, which the CoW guard forks) and emits the
        # first token
        for idx, stream, pages, plen, _cov in full:
            slot = _Slot(stream, pages, stop_len=plen + stream.max_tokens - 1)
            slot.awaiting_first = False
            with self._cond:
                self._slot_state[idx] = slot
                self._table[idx, :len(pages)] = pages
                self._lengths[idx] = plen - 1
                self._pending[idx] = stream.prompt[-1]
                self._stop[idx] = 0  # set by _grant_pages
                self._dirty = True
        # one prefill per (prompt-bucket, batch-bucket) group: an
        # admission burst costs O(groups) dispatches, not O(streams). The
        # first tokens stay on the device until the next flush.
        by_bucket: dict = {}
        for item in cold:
            tb = next(b for b in self._buckets if b >= item[3])
            by_bucket.setdefault(tb, []).append(item)
        for tb, group in by_bucket.items():
            bb = _pow2(len(group))
            padded = np.zeros((bb, tb), np.int32)
            lens = np.ones((bb,), np.int32)  # pad rows: true_len 1
            pids = np.full((bb, tb // ps), self._trash, np.int32)
            for row, (idx, stream, pages, plen, _cov) in enumerate(group):
                padded[row, :plen] = stream.prompt
                lens[row] = plen
                pids[row, :len(pages)] = pages
                self._prefill_token_count += plen
            self._prefill_groups.add((bb, tb))
            logits = self._program("prefill", self._to_device(padded),
                                   self._to_device(lens),
                                   self._to_device(pids))
            self._install_prefilled(group,
                                    torch.argmax(logits, dim=-1)
                                    .to(torch.int32))
        # warm tails ride the ctx-aware prefill, bucketed by (cached
        # pages, tail length); tails start on a page boundary
        by_ctx: dict = {}
        for item in warm:
            idx, stream, pages, plen, covered = item
            cb = min(_pow2(covered // ps), self._pps)
            tb = next(b for b in self._buckets if b >= plen - covered)
            by_ctx.setdefault((cb, tb), []).append(item)
        for (cb, tb), group in by_ctx.items():
            bb = _pow2(len(group))
            padded = np.zeros((bb, tb), np.int32)
            lens = np.ones((bb,), np.int32)
            pids = np.full((bb, tb // ps), self._trash, np.int32)
            ctab = np.full((bb, cb), self._trash, np.int32)
            clen = np.zeros((bb,), np.int32)
            for row, (idx, stream, pages, plen, cov) in enumerate(group):
                cp = cov // ps
                tl = plen - cov
                padded[row, :tl] = stream.prompt[cov:]
                lens[row] = tl
                pids[row, :len(pages) - cp] = pages[cp:]
                ctab[row, :cp] = pages[:cp]
                clen[row] = cov
                self._prefill_token_count += tl
            self._prefill_ctx_groups.add((bb, cb, tb))
            logits = self._program(
                "prefill_ctx",
                self._to_device(padded), self._to_device(lens),
                self._to_device(pids), self._to_device(ctab),
                self._to_device(clen))
            self._install_prefilled(group,
                                    torch.argmax(logits, dim=-1)
                                    .to(torch.int32))
        if cold or warm:
            self._mark_pool_written()

    # ---- the prefill and copy programs (store-dispatched: see __init__)
    def _program(self, name: str, *args):
        """Run the step, verify, prefill, prefill_ctx or copy program:
        through its store dispatcher when the process has a store, else
        the method itself."""
        dispatcher = getattr(self, "_" + name)
        if dispatcher is not None:
            return dispatcher(*args)
        if name in ("step", "verify"):
            return self._run_program(name)
        return getattr(self, f"_{name}_program")(*args)

    def _prefill_program(self, padded, lens, pids) -> torch.Tensor:
        """A cold prefill group into the pool; its last-position logits."""
        logits, _ = paged_prefill(self.params, padded, lens, self._pool,
                                  pids, self.cfg)
        return logits

    def _prefill_ctx_program(self, padded, lens, pids, ctab,
                             clen) -> torch.Tensor:
        """A warm-tail prefill group over cached pages; its logits."""
        logits, _ = paged_prefill_ctx(self.params, padded, lens, self._pool,
                                      pids, ctab, clen, self.cfg)
        return logits

    def _copy_program(self, src: int, dst: int) -> None:
        copy_page(self._pool, src, dst)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _install_prefilled(self, group, first) -> None:
        """Install slots for one prefill group; first tokens stay on the
        device until the next flush (`self._deferred`)."""
        members = []
        for row, (idx, stream, pages, plen, _cov) in enumerate(group):
            slot = _Slot(stream, pages, stop_len=plen + stream.max_tokens - 1)
            members.append((row, idx))
            with self._cond:
                self._slot_state[idx] = slot
                self._table[idx, :len(pages)] = pages
                self._lengths[idx] = plen
                self._pending[idx] = 0  # real value still on the device
                self._stop[idx] = 0  # set by _grant_pages
                self._dirty = True
        self._deferred.append((first, members))

    # ---- page granting
    def _grant_pages(self) -> None:
        """Before a dispatch: give every occupied slot pages covering its
        next advance window (`horizon` plain steps, or the `spec_k` + 1
        verify width, capped at its token budget), fork every shared page
        in that window, and set its device `stop` bound to the granted
        frontier — a slot the pool cannot extend stops advancing there."""
        adv = (self.spec_k + 1) if self.spec_k else self.horizon
        with self._cond:
            for i, slot in enumerate(self._slot_state):
                if slot is None:
                    continue
                length = int(self._lengths[i])
                target = min(length + adv, slot.stop_len)
                want = pages_for_tokens(target, self.page_size)
                granted = False
                while len(slot.pages) < want:
                    page = self._alloc_page()
                    if page is None:
                        break
                    self._table[i, len(slot.pages)] = page
                    slot.pages.append(page)
                    granted = True
                if granted:
                    self._peak_pages = max(self._peak_pages,
                                           self.pages_in_use)
                stop = min(slot.stop_len, len(slot.pages) * self.page_size)
                if stop > length:
                    stop = self._cow_guard(i, slot, length, stop)
                if stop <= length and slot.stop_len > length:
                    self._counts.add("admission_waits")  # page-starved
                if stop != self._stop[i]:
                    self._stop[i] = stop
                    self._dirty = True

    def _cow_guard(self, i: int, slot: _Slot, length: int,
                   stop: int) -> int:
        """Copy-on-write fence: positions [length, stop) are about to be
        written, so every page there still shared (another reader, or
        retained by the cache) is forked into a private copy first. When
        no page can be had for a fork, the slot's stop clamps to the
        shared frontier. Caller holds the lock."""
        ps = self.page_size
        for j in range(length // ps, (stop - 1) // ps + 1):
            page = slot.pages[j]
            if not self._is_shared(page):
                continue
            new = self._alloc_page()
            if new is None:
                return max(length, j * ps)
            try:
                chaos.hit("decode.fork")
                self._program("copy", page, new)
                self._plan_copy = True
            except BaseException:
                self._release_page(new)
                raise
            slot.pages[j] = new
            self._table[i, j] = new
            slot.no_cache.add(new)
            self._release_page(page)
            self._prefix_counts.add("forks")
            self._dirty = True
        return stop

    # ---- the step programs: eager bodies, captured as CUDA graphs
    def _step_eager(self) -> None:
        """`horizon` chained decode steps on the persistent buffers, in
        place: per-slot activity is `lengths < stop`, so a slot out of
        budget or out of granted pages holds still exactly where it
        should. No host sync."""
        for k in range(self.horizon):
            act = self._d_lengths < self._d_stop
            logits, _ = paged_decode_step(
                self.params, self._d_tokens, self._pool, self._d_table,
                self._d_lengths, act, self.cfg, kernel=self.decode_kernel)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            self._d_tokens.copy_(torch.where(act, nxt, self._d_tokens))
            self._d_lengths.add_(act.to(torch.int32))
            self._d_out[k].copy_(nxt)

    def _verify_eager(self) -> None:
        """ONE widened verify step on the persistent verify buffers: the
        argmax after every column lands in `_v_out`."""
        tokens, lengths, widths, table = self._verify_views(self._vd_ctrl)
        logits, _ = paged_verify_step(
            self.params, tokens, self._pool, table, lengths, widths,
            self.cfg, kernel=self.decode_kernel)
        self._v_out.copy_(torch.argmax(logits, dim=-1).to(torch.int32))

    def _idle_step(self) -> None:
        """Make the step's inputs idle (no slot active: every write goes
        to the trash page) for the capture's warm-up run."""
        self._d_lengths.zero_()
        self._d_stop.zero_()
        self._dirty = True  # the real state is uploaded before a replay

    def _idle_verify(self) -> None:
        self._verify_views(self._vd_ctrl)[2].zero_()  # widths 0: all trash

    def _run_program(self, name: str) -> None:
        """Run the step ("step") or verify ("verify") program: replay its
        graph (captured at first use) on the card, eagerly on the CPU."""
        body = self._step_eager if name == "step" else self._verify_eager
        if not self._capture:
            width = self.horizon if name == "step" else self.spec_k + 1
            self._eager_shapes.add((name, self.slots, width))
            body()
            return
        g = self._graphs.get(name)
        if g is None:
            raise AssertionError(f"{name} graph used before its capture")
        g.graph.replay()
        g.replays += 1

    def _ensure_graph(self, name: str) -> None:
        """Capture the step or verify program once, on the calling
        (scheduler) thread: a warm-up run on a side stream with idle
        inputs (it writes only the trash page), then the capture. The
        wrappers count what this thread records under capture apart from
        real launches; that count x replays is `graph_launches()`."""
        if not self._capture or name in self._graphs:
            return
        body, idle = ((self._step_eager, self._idle_step) if name == "step"
                      else (self._verify_eager, self._idle_verify))
        dev = self.device
        t0 = time.perf_counter()
        with _CAPTURE_LOCK:
            idle()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                body()
            torch.cuda.current_stream(dev).wait_stream(side)
            before = {n: f() for n, f in _CAPTURED_LAUNCHES.items()}
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._graph_pool,
                                  capture_error_mode="thread_local"):
                body()
        recorded = {n: f() - before[n] for n, f in _CAPTURED_LAUNCHES.items()}
        self._graph_pool = graph.pool()
        with self._cond:  # snapshot() iterates the graphs
            self._graphs[name] = _Graph(graph, recorded,
                                        (time.perf_counter() - t0) * 1e3)

    def _upload_step(self) -> None:
        """Copy every step control array to its persistent device buffer
        in one synchronous copy: the host mirrors are mutated right
        after, so the copy must have read them before it returns."""
        self._d_ctrl.copy_(torch.from_numpy(self._h_ctrl))

    # ---- plain dispatch (horizon token steps)
    def _runnable(self) -> List[int]:
        """Occupied slots with room to advance. Caller holds the lock."""
        return [i for i, s in enumerate(self._slot_state)
                if s is not None and self._stop[i] > self._lengths[i]]

    def _dispatch_plain(self) -> bool:
        self._grant_pages()
        with self._cond:
            if not self._runnable():
                return False
        # captured at the first dispatch that runs a slot (so a loop
        # that never decodes, e.g. a prefill-role one, captures nothing)
        self._ensure_graph("step")
        with self._cond:
            runnable = self._runnable()
            before = self._lengths.copy()
            if self._dirty:
                self._upload_step()
                self._dirty = False
            # overlay deferred prefill tokens (still on the device) into
            # the persistent feedback buffer — one scatter per group
            for arr, members in self._deferred:
                rows = torch.tensor([r for r, _ in members],
                                    device=self.device)
                idxs = torch.tensor([i for _, i in members],
                                    device=self.device)
                self._d_tokens[idxs] = arr[rows]
        t0 = time.perf_counter()
        self._program("step")
        self._plan_step = True
        # the (K, S) token copy to the host is the sync the streams need
        toks = self._d_out.cpu().numpy()
        self._observe_step(time.perf_counter() - t0)
        self._counts.add("dispatches")
        # KV read accounting mirroring the chain: inner step k runs at
        # cursor before+k, clamped at each slot's stop bound
        advance = np.maximum(self._stop - before, 0)
        for k in range(self.horizon):
            cur = before + np.minimum(k, advance)
            self._kv_read.add("kernel", decode_read_bytes(
                self._pool, cur, self._pps))
            self._kv_read.add("gather", decode_read_bytes(
                self._pool, cur, self._pps, dense=True))
        self._flush_first_tokens()  # emit firsts BEFORE chunk tokens
        for i in runnable:
            slot = self._slot_state[i]
            if slot is None:  # retired at flush (eos on first token)
                continue
            consumed = min(self.horizon, int(self._stop[i] - before[i]))
            with self._cond:
                self._lengths[i] = before[i] + consumed
            for j in range(consumed):
                tok = int(toks[j, i])
                self._pending[i] = tok
                slot.emitted += 1
                self._emit_and_maybe_finish(i, slot, tok)
                if self._slot_state[i] is None:
                    break  # retired: discard the chain's overshoot
        return True

    # ---- speculative dispatch (draft k on the host, verify k+1 wide)
    def _dispatch_spec(self) -> bool:
        """One draft-and-verify round: flush the deferred firsts, draft
        on the host, run ONE (S, k+1) verify, accept the longest run
        matching the target's argmax plus the target's own token, roll
        back by not moving the cursor past it."""
        if self.occupied_slots == 0:
            return False
        # both graphs up front, so no capture stalls a live round
        self._ensure_graph("step")
        self._ensure_graph("verify")
        if self._deferred:
            self._flush_first_tokens()
            self._dirty = True  # firsts never reached the device carry
        self._grant_pages()
        with self._cond:
            runnable = self._runnable()
            if not runnable:
                return False
            before = self._lengths.copy()
        W = self.spec_k + 1
        tokens = np.zeros((self.slots, W), np.int32)
        widths = np.zeros((self.slots,), np.int32)
        proposals = {}
        model_rows = []
        for i in runnable:
            slot = self._slot_state[i]
            tokens[i, 0] = self._pending[i]
            widths[i] = 1
            # >= 2 means at least one draft position fits under the
            # granted/budget frontier
            room = int(self._stop[i] - before[i])
            if room < 2 or not slot.stream.speculation:
                continue
            if self._drafter.kind == "model":
                model_rows.append(i)
            else:
                history = slot.stream.prompt + slot.stream._generated
                prop = self._drafter.propose(history,
                                             min(self.spec_k, room - 1))
                if prop:
                    proposals[i] = [int(t) for t in prop]
        if model_rows:
            # one fixed-shape (S, window) batch — idle rows ride along
            win = self._drafter.window
            windows = np.zeros((self.slots, win), np.int32)
            for i in model_rows:
                slot = self._slot_state[i]
                hist = (slot.stream.prompt + slot.stream._generated)[-win:]
                windows[i, win - len(hist):] = hist
            drafted = self._drafter.propose_all(windows, self.spec_k)
            for i in model_rows:
                room = int(self._stop[i] - before[i])
                prop = [int(t) for t in
                        drafted[i, :min(self.spec_k, room - 1)]]
                if prop:
                    proposals[i] = prop
        if not proposals:
            # nothing drafted: the plain width-1 step instead
            return self._dispatch_plain()
        for i, prop in proposals.items():
            n = len(prop)
            tokens[i, 1:1 + n] = prop
            widths[i] = 1 + n
            self._spec_counts.add("proposed", n)
        v_tokens, v_lengths, v_widths, v_table = self._verify_views(
            self._vh_ctrl)
        v_tokens[:] = tokens
        v_lengths[:] = before
        v_widths[:] = widths
        v_table[:] = self._table
        t0 = time.perf_counter()
        self._vd_ctrl.copy_(torch.from_numpy(self._vh_ctrl))
        self._program("verify")
        self._plan_verify = True
        out = self._v_out.cpu().numpy()  # (S, W) argmax
        self._observe_step(time.perf_counter() - t0)
        self._counts.add("dispatches")
        self._spec_counts.add("rounds")
        # column j of slot i attends at cursor before+j (clamped to its
        # real width)
        for j in range(int(widths.max())):
            cur = before + np.minimum(j, np.maximum(widths - 1, 0))
            self._kv_read.add("kernel", decode_read_bytes(
                self._pool, cur, self._pps))
            self._kv_read.add("gather", decode_read_bytes(
                self._pool, cur, self._pps, dense=True))
        for i in runnable:
            slot = self._slot_state[i]
            if slot is None:
                continue
            prop = proposals.get(i, [])
            m = 0
            while m < len(prop) and prop[m] == int(out[i, m]):
                m += 1
            with self._cond:
                self._lengths[i] = before[i] + m + 1
            if prop:
                self._spec_counts.add("accepted", m)
            for j in range(m + 1):
                tok = int(out[i, j])
                self._pending[i] = tok
                slot.emitted += 1
                self._emit_and_maybe_finish(i, slot, tok)
                if self._slot_state[i] is None:
                    break  # retired (eos/budget): overshoot discarded
        # host cursors moved without the plain device carry: a later
        # plain dispatch must re-upload
        self._dirty = True
        return True

    def _flush_first_tokens(self) -> None:
        """Read deferred prefill tokens (one copy per prefill group) and
        emit them."""
        deferred, self._deferred = self._deferred, []
        for arr, members in deferred:
            host = arr.cpu().numpy()
            for row, i in members:
                slot = self._slot_state[i]
                if slot is None or not slot.awaiting_first:
                    continue  # failed/cleared meanwhile
                tok = int(host[row])
                slot.awaiting_first = False
                self._pending[i] = tok
                slot.emitted += 1
                self._emit_and_maybe_finish(i, slot, tok)

    # ---- emission / retirement
    def _emit_and_maybe_finish(self, idx: int, slot: _Slot,
                               token: int) -> None:
        stream = slot.stream
        stream._emit(token)
        self._counts.add("tokens_streamed")
        if stream.eos_id is not None and token == stream.eos_id:
            self._retire(idx, slot, "eos")
        elif slot.emitted >= stream.max_tokens:
            self._retire(idx, slot, "max_tokens")

    def _retire(self, idx: int, slot: _Slot, reason: str,
                error: Optional[BaseException] = None) -> None:
        with self._cond:
            self._slot_state[idx] = None
            self._table[idx, :] = self._trash
            self._lengths[idx] = 0
            self._stop[idx] = 0
            self._pending[idx] = 0
            if (self._prefix is not None and slot.stream.prefix_cache
                    and reason in ("eos", "max_tokens", "preempted")):
                # seed the cache with the FULL prompt pages only; forked
                # pages never seed (their bytes diverged)
                n_full = len(slot.stream.prompt) // self.page_size
                self._prefix.insert(slot.stream.prompt, slot.pages[:n_full],
                                    skip=slot.no_cache)
            for page in slot.pages:
                self._release_page(page)
            self._dirty = True
            self._cond.notify_all()  # admissions may proceed
        slot.stream._finish(reason, error)


@torch.no_grad()
def _copy_params(dst, src) -> None:
    """Copy a tree of tensors into another of the same structure, in
    place (each leaf converted to the destination's device)."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_params(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_params(d, s)
    else:
        dst.copy_(torch.as_tensor(src).to(dst.device))


def _pow2(n: int) -> int:
    """The smallest power of two >= n (>= 1)."""
    b = 1
    while b < n:
        b *= 2
    return b
