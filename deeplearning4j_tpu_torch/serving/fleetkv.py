"""Fleet KV plane: prefix-affinity routing + peer-to-peer page shipping.

The prefix cache is per-replica: the router's least-outstanding
dispatch scatters a shared system prompt across all N replicas, so at
fleet scale the hit rate divides by N while every replica burns pages
caching the same prefix. This module is the host-side plumbing that
makes the fleet behave like ONE cache, in two independent halves:

1. **Prefix-affinity routing.** Each replica summarizes its trie as a
   compact set of fingerprints — one cumulative hash per page-aligned
   head-chunk path, the trie's own key unit (`PrefixIndex._chunks`) —
   piggybacked on the `/readyz` payload the fleet's health probe
   already fetches every heartbeat. The router hashes an incoming
   prompt's head chunks the same way and prefers the READY replica
   whose summary matches the longest run. Cold prompts (no match
   anywhere) fall back to a consistent-hash ring over the READY set,
   so repeats of a brand-new prefix keep landing on the same replica
   (the second request is the hit) and membership churn only remaps
   the keys the departed replica owned. Affinity is a PREFERENCE, not
   a mandate: shed pressure, SUSPECT state, and tier shedding all
   still win (`Fleet.select` honors the hint only inside a bounded
   load slack).

2. **Peer-to-peer page shipping.** When affinity cannot land the
   request on the replica that owns the prefix (slack exceeded,
   resume excludes it, replica mid-drain), the router names that
   replica as a DONOR hint instead. The chosen replica fetches the
   donor's hot pages over `POST /kv/export` — serialized with the
   checkpoint format's dtype-name/byte-view idiom (crc-framed raw
   array bytes, no pickle) — and installs them into its own pool +
   trie through the existing refcount machinery, so the subsequent
   admission sees a warm `paged_prefill_ctx` hit. Shipping is an
   optimization, never a correctness dependency: ANY failure (donor
   dead, timeout, crc mismatch, model identity mismatch, pool full)
   falls back to plain prefill of the same tokens.

Wire format (`pack_pages`/`unpack_pages`)::

    b"DL4JKV1\\n"
    <u32 header_len> <header json: page_size/chunks/layers/dtype/...>
    then chunk-major, layer-minor, K before V:
    <u32 frame_len> <u32 crc32> <raw array bytes>

The header carries the donor's decode `cache_key` — it pins model
config digest, page size, kernel lane and device, so a receiver can
reject bytes from a replica that reloaded onto a different checkpoint
shape mid-flight. Extension dtypes (bfloat16) round-trip exactly like
checkpoint shards: the logical dtype name in the header, the raw 16 bits
on the wire. The wire is byte-compatible with the JAX package's: a page
packed by either package unpacks in the other. Pages may be handed to
`pack_pages` as numpy arrays or as CPU tensors (a bfloat16 tensor is
written as its raw bits); `unpack_pages` returns numpy arrays, a
bfloat16 page viewed as `np.uint16` (numpy cannot name bfloat16 without
ml_dtypes, which this package does not need).

Everything here is host-side bookkeeping; the install is one
host-to-device copy plus in-place writes into the pool
(`paged_kv.install_pages`), so the captured decode graphs never change.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple
from urllib import error as _urlerror
from urllib import request as _urlrequest

import numpy as np

import torch

from deeplearning4j_tpu_torch.checkpoint.format import (_dtype_name,
                                                        _storage_dtype,
                                                        host_bits)

__all__ = [
    "MODE_ON", "MODE_AFFINITY", "MODE_OFF", "MODES",
    "ShipError", "hash_chunks", "HashRing", "pack_pages",
    "unpack_pages", "fetch_pages", "summary_heads", "match_summary",
    "RouterAffinity", "Placement",
]

#: full plane: affinity routing + donor hints + page shipping
MODE_ON = "on"
#: routing only — summaries and placement, no /kv/export traffic
MODE_AFFINITY = "affinity-only"
#: feature off: no summaries, no hashing, no shipping
MODE_OFF = "off"
MODES = (MODE_ON, MODE_AFFINITY, MODE_OFF)

#: per-path fingerprint depth: affinity only needs to discriminate the
#: HEAD of a prompt (system prompt + few-shot template); deeper chunks
#: add summary bytes without adding routing signal
MAX_HEAD_CHUNKS = 16
#: per-replica summary bound — most-recently-touched paths first, so
#: under pressure the summary degrades to "what is hot", never "what
#: happens to sort first"
MAX_SUMMARY_HASHES = 512
#: `Fleet.select` honors an affinity preference only while the target
#: is within this many outstanding requests of the least-loaded READY
#: replica — affinity must never stack a convoy on one box
PLACEMENT_SLACK = 4
#: consistent-hash ring virtual nodes per replica (higher = smoother
#: cold-placement spread, linearly more hashing on membership change)
RING_VNODES = 64

_MAGIC = b"DL4JKV1\n"
_FRAME = struct.Struct("<II")  # (byte length, crc32)
_U32 = struct.Struct("<I")


class ShipError(RuntimeError):
    """A page-shipping exchange failed (transport, framing, crc, or
    identity mismatch). Always recoverable: the receiver falls back to
    plain prefill of the exact same tokens."""


# --------------------------------------------------------------- hashing
def hash_chunks(tokens: Sequence[int], page_size: int,
                limit: Optional[int] = MAX_HEAD_CHUNKS) -> List[int]:
    """Cumulative fingerprint per FULL page-aligned head chunk of
    `tokens` — chunk j's hash covers chunks 0..j, so one value
    identifies a whole root-to-depth-j trie path. Mirrors
    `PrefixIndex._chunks` exactly (full chunks only, int token ids);
    a partial trailing page contributes nothing, same as the trie."""
    ps = int(page_size)
    n = len(tokens) // ps
    if limit is not None:
        n = min(n, int(limit))
    out: List[int] = []
    h = 0
    for j in range(n):
        chunk = tokens[j * ps:(j + 1) * ps]
        h = zlib.crc32(
            struct.pack(f"<{ps}q", *(int(t) for t in chunk)), h)
        out.append(h)
    return out


class HashRing:
    """Consistent-hash ring over replica ids: cold prompts with no
    summary match anywhere still get STABLE placement (the repeat
    request is the cache hit), and adding/removing a replica only
    remaps the keys it owned."""

    def __init__(self, ids: Sequence[str], vnodes: int = RING_VNODES):
        points: List[Tuple[int, str]] = []
        for rid in ids:
            for v in range(vnodes):
                points.append(
                    (zlib.crc32(f"{rid}#{v}".encode()), rid))
        points.sort()
        self._points = points

    def lookup(self, key: int) -> Optional[str]:
        """Owner of `key`: first ring point clockwise of the key."""
        points = self._points
        if not points:
            return None
        lo, hi = 0, len(points)
        while lo < hi:
            mid = (lo + hi) // 2
            if points[mid][0] < key:
                lo = mid + 1
            else:
                hi = mid
        return points[lo % len(points)][1]


# --------------------------------------------------------- wire format
def pack_pages(meta: dict, chunks: Sequence[Sequence[Tuple]]) -> bytes:
    """Serialize shipped pages: `chunks[j][l] = (k, v)` host arrays for
    chunk j, layer l. crc-framed raw bytes, no pickle — the checkpoint
    shard discipline (checkpoint/format.py) applied to KV pages."""
    dtype = None
    parts = [_MAGIC]
    frames: List[bytes] = []
    for chunk in chunks:
        for k, v in chunk:
            for arr in (k, v):
                if isinstance(arr, torch.Tensor):
                    name = _dtype_name(arr.dtype)
                    a = host_bits(arr.detach().cpu().contiguous())
                else:
                    a = np.ascontiguousarray(arr)
                    name = _dtype_name(a.dtype)
                if dtype is None:
                    dtype = name
                raw = a.tobytes()
                frames.append(
                    _FRAME.pack(len(raw), zlib.crc32(raw)) + raw)
    header = dict(meta)
    header["dtype"] = dtype
    head = json.dumps(header, sort_keys=True).encode()
    parts.append(_U32.pack(len(head)))
    parts.append(head)
    parts.extend(frames)
    return b"".join(parts)


def unpack_pages(payload: bytes) -> Tuple[dict, List[List[Tuple]]]:
    """Inverse of `pack_pages`: returns (header, chunks) with every
    frame crc-verified and every array rebuilt as a numpy view of its
    bytes (a bfloat16 page as `np.uint16`, `header["dtype"]` naming the
    logical dtype). Raises ShipError on ANY framing defect — a truncated or
    corrupted ship must fall back, never install garbage K/V."""
    if not payload.startswith(_MAGIC):
        raise ShipError("kv ship payload: bad magic")
    off = len(_MAGIC)
    try:
        (hlen,) = _U32.unpack_from(payload, off)
        off += _U32.size
        header = json.loads(payload[off:off + hlen].decode())
        off += hlen
    except (struct.error, ValueError) as e:
        raise ShipError(f"kv ship payload: bad header ({e})") from None
    n_chunks = int(header.get("chunks", 0))
    n_layers = int(header.get("layers", 0))
    shape = tuple(header.get("shape", ()))
    if n_chunks == 0:
        return header, []
    if n_layers < 1 or len(shape) != 3:
        raise ShipError("kv ship payload: bad geometry header")
    try:
        dtype = _storage_dtype(header["dtype"])
    except Exception as e:
        raise ShipError(
            f"kv ship payload: unknown dtype ({e})") from None
    expect = int(np.prod(shape)) * dtype.itemsize
    # one writable copy of the payload: every page below is a view of it
    # (a view of the immutable `bytes` would be read-only)
    buf = memoryview(bytearray(payload))
    chunks: List[List[Tuple]] = []
    for _ in range(n_chunks):
        layers: List[Tuple] = []
        for _ in range(n_layers):
            pair = []
            for _ in range(2):  # K then V
                try:
                    ln, crc = _FRAME.unpack_from(payload, off)
                except struct.error:
                    raise ShipError(
                        "kv ship payload: truncated frame") from None
                off += _FRAME.size
                raw = buf[off:off + ln]
                off += ln
                if len(raw) != ln or ln != expect:
                    raise ShipError(
                        "kv ship payload: short frame")
                if zlib.crc32(raw) != crc:
                    raise ShipError(
                        "kv ship payload: frame failed its crc32 "
                        "check — refusing to install corrupt K/V")
                pair.append(np.frombuffer(raw, np.uint8)
                            .view(dtype).reshape(shape))
            layers.append((pair[0], pair[1]))
        chunks.append(layers)
    return header, chunks


def fetch_pages(donor_url: str, tokens: Sequence[int],
                timeout: float,
                max_chunks: Optional[int] = None) -> bytes:
    """POST the donor's `/kv/export` and return the raw framed payload.
    Transport failures of every flavor surface as ShipError — the
    caller's fallback path does not care which flavor."""
    body = {"tokens": [int(t) for t in tokens]}
    if max_chunks is not None:
        body["max_chunks"] = int(max_chunks)
    req = _urlrequest.Request(
        donor_url.rstrip("/") + "/kv/export",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="POST")
    try:
        with _urlrequest.urlopen(req, timeout=timeout) as resp:
            if resp.status != 200:
                raise ShipError(
                    f"donor replied {resp.status}")
            return resp.read()
    except ShipError:
        raise
    except (_urlerror.URLError, OSError, TimeoutError) as e:
        raise ShipError(f"kv export fetch failed: {e}") from None


# ------------------------------------------------------- summary/match
def summary_heads(index, page_size: int,
                  max_hashes: int = MAX_SUMMARY_HASHES,
                  max_chunks: int = MAX_HEAD_CHUNKS) -> List[int]:
    """Fingerprint a replica's trie for the /readyz summary: one
    cumulative hash per cached head-chunk path, most recently touched
    paths first, deduplicated, capped at `max_hashes`. Only tokens the
    trie RETAINS are hashed — requests that opted out of the prefix
    cache never seeded the trie, so their prompt bytes can never leak
    into a summary (the opt-out satellite's replica half)."""
    heads: List[int] = []
    seen = set()
    for seq in index.head_paths():
        for h in hash_chunks(seq, page_size, limit=max_chunks):
            if h not in seen:
                seen.add(h)
                heads.append(h)
        if len(heads) >= max_hashes:
            break
    return heads[:max_hashes]


def match_summary(summary: Optional[dict],
                  hashes: Sequence[int]) -> int:
    """Longest head-chunk run of `hashes` present in one replica's
    summary (0 = no overlap / no summary / page-size mismatch)."""
    if not summary or not hashes:
        return 0
    heads = summary.get("heads")
    if not heads:
        return 0
    head_set = heads if isinstance(heads, (set, frozenset)) \
        else frozenset(heads)
    depth = 0
    for j, h in enumerate(hashes):
        if h not in head_set:
            break
        depth = j + 1
    return depth


class Placement:
    """One routing decision: `prefer` is the replica id `Fleet.select`
    should lean toward; `donor`/`donor_url` name the replica whose
    pages are worth shipping when the request lands elsewhere; `depth`
    is the matched head-chunk run (0 = ring-placed cold prompt)."""

    __slots__ = ("prefer", "depth", "donor", "donor_url")

    def __init__(self, prefer: Optional[str], depth: int,
                 donor: Optional[str], donor_url: Optional[str]):
        self.prefer = prefer
        self.depth = depth
        self.donor = donor
        self.donor_url = donor_url


class RouterAffinity:
    """Router-side half of the plane: turns (prompt, fleet summaries)
    into a Placement. Stateless apart from a per-membership HashRing
    cache. Summary head-sets are frozen PER CALL, never cached by
    payload identity: each heartbeat probe parses a fresh summary
    dict and frees the old one, so CPython readily recycles the
    address — an `id()`-keyed cache would serve the PREVIOUS
    payload's head-set (typically the pre-warm empty one) and
    silently turn every deep match into a ring placement. Freezing
    <= MAX_SUMMARY_HASHES ints per candidate is noise next to the
    generate request being routed."""

    def __init__(self, mode: str = MODE_ON):
        if mode not in MODES:
            raise ValueError(
                f"fleet-kv mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self._rings: Dict[Tuple[str, ...], HashRing] = {}

    @property
    def enabled(self) -> bool:
        return self.mode != MODE_OFF

    @property
    def shipping(self) -> bool:
        return self.mode == MODE_ON

    def plan(self, prompt: Sequence[int],
             summaries: Dict[str, Tuple[dict, str]]
             ) -> Optional[Placement]:
        """Place one prompt. `summaries` maps READY replica id ->
        (kv_summary payload, replica url). Returns None when affinity
        has nothing to say (mode off, no candidates, or the prompt is
        shorter than one page — sub-page prompts have no trie key, so
        hashing them would be pure noise). The CALLER gates on the
        request's prefix_cache opt-out: an opted-out prompt must never
        reach this method (its hashes must not leave the router's
        request handler — the opt-out satellite's router half)."""
        if self.mode == MODE_OFF or not summaries:
            return None
        # role filter (docs/FLEET.md "Disaggregated roles"): a
        # prefill-role replica never runs a generate stream, so it
        # must never become a prefer target, a donor hint, or a ring
        # owner here — its pages reach the decode side through the
        # explicit /prefill handoff, not through affinity placement
        summaries = {rid: sv for rid, sv in summaries.items()
                     if ((sv[0] or {}).get("role") or "unified")
                     != "prefill"}
        if not summaries:
            return None
        page_sizes = {int((s or {}).get("page_size", 0))
                      for s, _url in summaries.values()}
        page_sizes.discard(0)
        if len(page_sizes) != 1:
            return None  # mid-rollout heterogeneity: sit out
        ps = page_sizes.pop()
        hashes = hash_chunks(prompt, ps)
        if not hashes:
            return None
        best_id, best_depth = None, 0
        for rid in sorted(summaries):
            summary, _url = summaries[rid]
            depth = match_summary(
                {"heads": frozenset((summary or {}).get("heads")
                                    or ())}, hashes)
            if depth > best_depth:
                best_id, best_depth = rid, depth
        if best_id is not None:
            return Placement(best_id, best_depth, best_id,
                             summaries[best_id][1])
        ids = tuple(sorted(summaries))
        ring = self._rings.get(ids)
        if ring is None:
            ring = self._rings[ids] = HashRing(ids)
            if len(self._rings) > 64:  # membership churn bound
                self._rings = {ids: ring}
        return Placement(ring.lookup(hashes[0]), 0, None, None)
