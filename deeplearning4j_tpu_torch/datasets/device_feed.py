"""Device feed: shape-bucketed batch padding and prefetched host-to-device
copies, the counterpart of the JAX package's `datasets/device_feed.py`.

1. **Shape bucketing.** A ragged batch is zero-padded up to the smallest
   of a fixed set of bucket sizes (powers of two up to the iterator's
   batch size by default), and the real example count rides along as a
   0-d int32 device tensor (`FeedBatch.n_valid`). The train step turns
   it into a 0/1 row mask (`feed_mask`), so padded rows add no loss and
   no gradient, and the loss mean and AdaGrad's ÷batchSize use the real
   count. The same ladder and masking as the JAX package, so a stream
   meets the same few batch shapes.
2. **Prefetch.** Up to `prefetch` upcoming batches are copied ahead of
   the step: on a CUDA device each array is staged in pinned host memory
   and copied with `non_blocking=True`, so the copy runs on the copy
   engine while the current step computes (PyTorch's caching host
   allocator keeps a pinned buffer until its copy has finished).
3. **Per-rank feeding.** `sharding=` (a placement from
   `parallel.mesh.batch_sharding`) makes the feed yield only this rank's
   rows of each global batch: the batch is padded to its bucket on the
   host, sliced, and only the slice is copied. `align=` rounds every
   bucket up to a multiple of the data-axis size, so the slices are
   equal. `n_valid` stays the GLOBAL real-row count; padding sits at the
   tail of the global batch, so it lands on the last ranks, and a
   trainer computes its mask from global row indices
   (`feed_mask(..., offset=)`).
4. **Resume.** `cursor` counts the batches handed out in the current
   pass; `fast_forward(n)` drops the first `n` source batches of the
   next pass without padding or copying them, so a resumed run starts
   at a checkpoint's within-epoch cursor (the guardian's `epoch_batch`).

Telemetry, the JAX package's series: `dl4j_feed_batches`,
`dl4j_feed_padded_examples`, `dl4j_feed_bucket_hits{bucket=}` and the
`dl4j_feed_prefetch_depth` gauge, process-wide twins of `stats()`
(host counters; nothing is read from the device).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device, telemetry

__all__ = ["FeedBatch", "DeviceFeed", "feed_mask", "pow2_buckets",
           "bucket_for", "pad_rows", "DEFAULT_MIN_BUCKET"]

# feed pipeline telemetry: process-wide twins of the per-feed stats()
# counters, so bucket behavior and prefetch health show up in /metrics
# without holding a DeviceFeed reference
_M_BATCHES = telemetry.counter(
    "dl4j_feed_batches", "batches staged through DeviceFeed")
_M_PADDED = telemetry.counter(
    "dl4j_feed_padded_examples", "bucketing padding rows shipped")
_M_BUCKET = telemetry.counter(
    "dl4j_feed_bucket_hits", "batches landing in each bucket size")
_M_QUEUE = telemetry.gauge(
    "dl4j_feed_prefetch_depth", "device_put transfers in flight ahead "
    "of the train step (last observed window size)")

#: smallest bucket of the default ladder: tiny tail batches share one
#: shape instead of one each
DEFAULT_MIN_BUCKET = 8


def feed_mask(n_rows: int, n_valid, device=None, offset: int = 0):
    """(weights, count) for a batch of `n_rows` rows inside a train step.

    `n_valid` None means an unbucketed batch: no mask, the static count.
    Otherwise `n_valid` is the real count (a 0-d int tensor, or an int),
    and the weights are the float32 0/1 row mask over the padded rows.
    `offset` is the global index of the first row, for a rank holding a
    slice of a global batch (`n_valid` then counts the global rows)."""
    if n_valid is None:
        return None, n_rows
    if not isinstance(n_valid, torch.Tensor):
        n_valid = torch.tensor(int(n_valid), dtype=torch.int32,
                               device=device)
    rows = torch.arange(offset, offset + n_rows, device=n_valid.device)
    return (rows < n_valid).to(torch.float32), n_valid


def pow2_buckets(batch_size: int, min_bucket: int = DEFAULT_MIN_BUCKET,
                 align: int = 1) -> Tuple[int, ...]:
    """The default bucket ladder: powers of two in [min_bucket,
    batch_size) plus batch_size itself, each rounded up to a multiple of
    `align`."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    buckets = set()
    b = max(1, min_bucket)
    while b < batch_size:
        buckets.add(b)
        b *= 2
    buckets.add(batch_size)
    aligned = {-(-b // align) * align for b in buckets}
    return tuple(sorted(aligned))


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; an oversize batch gets a next-power-of-two
    escape bucket rather than an error."""
    for b in buckets:
        if b >= n:
            return b
    b = max(buckets)
    while b < n:
        b *= 2
    return b


def pad_rows(arr: torch.Tensor, bucket: int) -> torch.Tensor:
    """Zero-pad a tensor's leading dim up to `bucket` (no-op when already
    there). Forwards are per-row independent, so padded rows are sliced
    off the output."""
    n = arr.shape[0]
    if n == bucket:
        return arr
    if n > bucket:
        raise ValueError(f"batch of {n} rows exceeds bucket {bucket}")
    return torch.cat([arr, arr.new_zeros((bucket - n, *arr.shape[1:]))])


class FeedBatch(NamedTuple):
    """One device-resident training batch: `features`/`labels` padded to
    a bucket, `n_valid` the real example count (0-d int32 tensor)."""

    features: Any
    labels: Any
    n_valid: Any

    @property
    def bucket(self) -> int:
        return int(self.features.shape[0])


def _host_float(a) -> np.ndarray:
    """A batch array as numpy, float64 narrowed to float32 (as
    jnp.asarray does)."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == np.float64 else a


class DeviceFeed:
    """Wrap a DataSetIterator into a bucketed, prefetching device stream.

    Iterating a DeviceFeed resets the source and yields FeedBatch tuples
    whose tensors are on (or on their way to) `device` (None = the CUDA
    device). Safe to iterate repeatedly, one pass per epoch.

    Parameters
    ----------
    source : DataSetIterator (or any object with reset() and batch() whose
        iteration yields (features, labels) pairs).
    buckets : explicit bucket sizes; default `pow2_buckets(source.batch())`.
    prefetch : upcoming batches kept in flight (0 disables lookahead).
    sharding : optional placement of the batch dimension
        (`parallel.mesh.batch_sharding(mesh)`): the feed then yields this
        rank's rows of each global batch; `n_valid` stays the global real
        count.
    align : round every bucket up to a multiple of this (the data-axis
        size, so every rank's slice has the same rows).
    """

    def __init__(self, source, buckets: Optional[Sequence[int]] = None,
                 prefetch: int = 2, device=None, sharding=None,
                 align: int = 1):
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        self.source = source
        self.device = default_device(
            sharding.mesh.device if device is None and sharding is not None
            else device)
        if buckets is None:
            buckets = pow2_buckets(source.batch(), align=align)
        elif align > 1 and any(b % align for b in buckets):
            raise ValueError(
                f"explicit buckets {list(buckets)} must be multiples of "
                f"align={align}")
        self.sharding = sharding
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive, got {buckets}")
        self.prefetch = prefetch
        self.bucket_hits = {b: 0 for b in self.buckets}
        self.padded_examples = 0
        self.batches = 0
        #: absolute batch index within the current pass: the guardian's
        #: checkpoint cursor reads as "batches consumed this epoch"
        self.cursor = 0
        self._skip_next = 0

    # ------------------------------------------------------------ padding
    def _pad(self, ds) -> Tuple[np.ndarray, np.ndarray, int]:
        f, l = _host_float(ds.features), _host_float(ds.labels)
        n = f.shape[0]
        b = bucket_for(n, self.buckets)
        self.bucket_hits[b] = self.bucket_hits.get(b, 0) + 1
        self.padded_examples += b - n
        self.batches += 1
        _M_BATCHES.inc()
        _M_PADDED.inc(b - n)
        _M_BUCKET.labels(bucket=str(b)).inc()
        if b != n:
            f = np.concatenate([f, np.zeros((b - n, *f.shape[1:]), f.dtype)])
            l = np.concatenate([l, np.zeros((b - n, *l.shape[1:]), l.dtype)])
        return f, l, n

    def _put(self, padded) -> FeedBatch:
        f, l, n = padded

        def put(t):
            if self.device.type == "cuda":
                return t.pin_memory().to(self.device, non_blocking=True)
            return t.to(self.device)

        def host(a):
            if self.sharding is not None:
                a = self.sharding.local(a)
            return torch.from_numpy(np.require(a, requirements=["C", "W"]))

        return FeedBatch(put(host(f)), put(host(l)),
                         put(torch.tensor(n, dtype=torch.int32)))

    # ---------------------------------------------------------- streaming
    def fast_forward(self, n: int) -> None:
        """Drop the first `n` source batches of the NEXT pass, the
        mid-epoch resume primitive: the stream starts at a checkpoint's
        within-epoch cursor without padding or copying the skipped
        batches. One-shot (the pass after consumes the whole stream
        again); `cursor` starts at `n` for that pass."""
        if n < 0:
            raise ValueError(f"fast_forward must be >= 0, got {n}")
        self._skip_next = int(n)

    def _host_batches(self):
        self.source.reset()
        skip, self._skip_next = self._skip_next, 0
        self.cursor = skip
        for ds in self.source:
            if skip > 0:
                skip -= 1
                continue
            yield self._pad(ds)

    def __iter__(self) -> Iterator[FeedBatch]:
        """One epoch: bucketed batches with up to `prefetch` copies in
        flight ahead of the consumer."""
        window: deque = deque()
        depth = max(1, self.prefetch)
        for padded in self._host_batches():
            window.append(self._put(padded))
            if len(window) < depth:
                continue
            self.cursor += 1
            _M_QUEUE.set(len(window) - 1)
            yield window.popleft()
        while window:
            self.cursor += 1
            _M_QUEUE.set(len(window) - 1)
            yield window.popleft()

    # --------------------------------------------------- iterator surface
    def batch(self) -> int:
        return self.source.batch()

    def reset(self) -> None:
        self.source.reset()

    def close(self) -> None:
        close = getattr(self.source, "close", None)
        if close is not None:
            close()

    def stats(self) -> dict:
        """How many batches hit each bucket and how many padded
        (masked-out) rows were shipped."""
        return {"buckets": list(self.buckets),
                "bucket_hits": dict(self.bucket_hits),
                "padded_examples": int(self.padded_examples),
                "batches": int(self.batches)}
