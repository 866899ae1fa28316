"""Async prefetching DataSetIterator over the native BatchQueue.

Parity: the reference's data pipeline feeds the training loop
synchronously (DataSetIterator.next() does its IO/assembly inline);
DL4J grew an AsyncDataSetIterator later for exactly this reason. Here
the wrapper pairs with the C++ bounded ring (`runtime/native/native.cpp`
dl4j_queue_*, consumed through `runtime.native_loader.BatchQueue`): a
producer thread drains the source iterator and pushes (features, labels)
through two lock-stepped native queues, so host-side batch assembly
(CSV/IDX decode, window featurization, augmentation) overlaps the device
step instead of serializing with it.

The device step is often sub-millisecond, so any synchronous host work
between steps idles the card. `capacity` bounds the look-ahead
(double/triple buffering), keeping memory flat on arbitrarily long
streams.

The producer thread moves numpy arrays only and never touches CUDA: the
host-to-device copy stays with `DeviceFeed`, on the thread that runs
`fit`. The port's own copy of the JAX package's
`datasets/async_iterator.py`.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from deeplearning4j_tpu_torch.datasets.api import DataSet, DataSetIterator
from deeplearning4j_tpu_torch.runtime.native_loader import BatchQueue

log = logging.getLogger(__name__)

__all__ = ["AsyncDataSetIterator"]


class AsyncDataSetIterator(DataSetIterator):
    """Wrap any DataSetIterator; batches are produced ahead of
    consumption on a background thread through the native queue.

    `retries`/`backoff` (opt-in, default off) make the producer survive
    TRANSIENT source errors — a flaky network read, a storage blip: each
    failed has_next()/next() is re-attempted up to `retries` times with
    exponential backoff (backoff, 2*backoff, 4*backoff, ... seconds; the
    attempt budget resets after every successful batch). A source that
    advances its cursor before failing will skip that batch on retry —
    only wrap sources whose next() is repeatable. When the budget is
    exhausted the error relays to the consumer exactly as before."""

    def __init__(self, source: DataSetIterator, capacity: int = 4,
                 reset_timeout: float = 10.0, retries: int = 0,
                 backoff: float = 0.1):
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        if backoff < 0:
            raise ValueError(f"backoff must be >= 0, got {backoff}")
        self.source = source
        self.capacity = capacity
        self.retries = retries
        self.backoff = backoff
        self.reset_timeout = reset_timeout  # join wait for a slow source
        self._fq: Optional[BatchQueue] = None
        self._lq: Optional[BatchQueue] = None
        self._producer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._next: Optional[DataSet] = None  # one-batch lookahead
        self._stop = threading.Event()  # interrupts retry backoff sleeps
        super().__init__(batch_size=source.batch(),
                         num_examples=source.num_examples()
                         if self._safe_num_examples() else -1)
        self._start()

    def _safe_num_examples(self) -> bool:
        try:
            self.source.num_examples()
            return True
        except NotImplementedError:
            return False

    # ---------------------------------------------------------- producer
    def _start(self) -> None:
        self._fq = BatchQueue(self.capacity)
        self._lq = BatchQueue(self.capacity)
        self._error = None
        self._next = None
        self._stop = threading.Event()
        stop = self._stop  # this producer generation's own flag

        def next_batch() -> Optional[DataSet]:
            """One (has_next, next) cycle with the bounded retry budget;
            None = stream exhausted. Raises once retries run out — the
            outer handler relays, preserving historical behavior. If a
            failed next() advanced the source PAST its end (has_next goes
            False mid-retry), the saved error is raised rather than
            reporting a clean-but-truncated epoch."""
            attempt = 0
            pending: Optional[Exception] = None
            while True:
                try:
                    if not self.source.has_next():
                        if pending is not None:
                            raise pending
                        return None
                    return self.source.next()
                except MemoryError:
                    # retrying an allocation under memory pressure only
                    # burns backoff sleeps — relay immediately
                    raise
                # KeyboardInterrupt/SystemExit are not Exception: they
                # propagate straight to the outer relay too
                except Exception as e:
                    if e is pending:  # the end-of-stream re-raise above
                        raise
                    pending = e
                    attempt += 1
                    if attempt > self.retries:
                        raise
                    delay = self.backoff * (2 ** (attempt - 1))
                    log.warning(
                        "async producer: source error (attempt %d/%d), "
                        "retrying in %.2fs: %s", attempt, self.retries,
                        delay, e)
                    # interruptible: reset()/close() set the stop flag so
                    # a long backoff can't outlive the consumer (and make
                    # reset()'s join time out on a healthy producer)
                    if stop.wait(delay):
                        raise

        def produce():
            try:
                self.source.reset()
                while True:
                    ds = next_batch()
                    if ds is None:
                        return
                    if not self._fq.push(ds.features):
                        return  # consumer closed
                    if not self._lq.push(ds.labels):
                        return
            except BaseException as e:  # noqa: BLE001 — relay to consumer
                self._error = e
            finally:
                self._fq.close()
                self._lq.close()

        self._producer = threading.Thread(target=produce,
                                          name="async-dsi", daemon=True)
        self._producer.start()

    def _pop(self) -> Optional[DataSet]:
        f = self._fq.pop()
        if f is None:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            return None
        labels = self._lq.pop()
        return DataSet(f, labels)

    # --------------------------------------------------- iterator surface
    def input_columns(self) -> int:
        return self.source.input_columns()

    def total_outcomes(self) -> int:
        return self.source.total_outcomes()

    def has_next(self) -> bool:
        if self._next is None:
            self._next = self._pop()
        return self._next is not None

    def next(self, num: Optional[int] = None) -> DataSet:
        if not self.has_next():
            raise StopIteration
        ds, self._next = self._next, None
        if self.pre_processor is not None:
            ds = self.pre_processor(ds)
        return ds

    def reset(self) -> None:
        """Tear down the in-flight producer and restart from the source's
        beginning."""
        self._stop.set()  # wake a producer parked in a retry backoff
        self._fq.close()
        self._lq.close()
        if self._producer is not None:
            self._producer.join(timeout=self.reset_timeout)
            if self._producer.is_alive():
                # a second producer over the same source would interleave
                # batches with this stuck one — fail loudly instead
                raise RuntimeError(
                    "AsyncDataSetIterator.reset: producer thread still "
                    f"running (source.next() blocked >{self.reset_timeout}"
                    "s); raise reset_timeout for slow sources rather than "
                    "risking two producers over the same source")
        self._start()

    def close(self) -> None:
        self._stop.set()
        self._fq.close()
        self._lq.close()
