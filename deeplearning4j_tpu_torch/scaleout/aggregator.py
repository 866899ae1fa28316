"""Result aggregators, the counterpart of the JAX package's
`scaleout/aggregator.py`: host code over numpy, so the same job results
average to the same bits in either package.

Parity: reference INDArrayAggregator.java:35-59 (sum packed parameter
vectors, divide by count — the parameter-averaging reduce under every
distributed runtime) and IterateAndUpdateImpl (replay UpdateSaver contents
through an aggregator).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from deeplearning4j_tpu_torch.scaleout.api import Job, JobAggregator


class ParameterAveragingAggregator(JobAggregator):
    """Average packed parameter vectors (reference INDArrayAggregator)."""

    def __init__(self):
        self._sum: Optional[np.ndarray] = None
        self._count = 0

    def accumulate(self, job: Job) -> None:
        vec = np.asarray(job.result if isinstance(job, Job) else job)
        if self._sum is None:
            self._sum = vec.astype(np.float64).copy()
        else:
            if vec.shape != self._sum.shape:
                raise ValueError(
                    f"Update shape {vec.shape} != accumulated {self._sum.shape}")
            self._sum += vec
        self._count += 1

    def aggregate(self) -> Optional[np.ndarray]:
        if self._sum is None or self._count == 0:
            return None
        return (self._sum / self._count).astype(np.float32)

    def reset(self) -> None:
        self._sum = None
        self._count = 0


def iterate_and_update(tracker, aggregator: JobAggregator) -> Any:
    """Replay every saved update through the aggregator
    (reference IterateAndUpdateImpl / StateTracker.updates())."""
    for worker_id in tracker.worker_updates():
        update = tracker.load_update(worker_id)
        if update is not None:
            aggregator.accumulate(Job(work=None, worker_id=worker_id,
                                      result=update))
    return aggregator.aggregate()
