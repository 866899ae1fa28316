"""FIFO queue that spills every element to disk.

Parity: reference core/util/DiskBasedQueue.java:38-203 — each element is
serialized to its own file under a scratch directory; the in-memory state
is only the ordered list of file paths, so arbitrarily long queues hold
O(1) payload in RAM. Used to stage datasets/updates bigger than memory.

Elements are serialized with the same npz+JSON codec as checkpoints
(scaleout/checkpoint.py) — numpy arrays, tensors and JSON-able containers, no
pickle, so a queue directory on shared storage can't execute code on read.

Host code: the port's own copy of the JAX package's
`utils/disk_based_queue.py`, the same behaviour line for line.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import uuid
from collections import deque
from typing import Any, Iterator, Optional

from deeplearning4j_tpu_torch.scaleout.checkpoint import dump_payload, load_payload


class DiskBasedQueue:
    def __init__(self, path: Optional[str] = None):
        self.dir = path or tempfile.mkdtemp(prefix="dl4j_tpu_queue_")
        os.makedirs(self.dir, exist_ok=True)
        self._paths: deque = deque()
        self._lock = threading.Lock()

    # ------------------------------------------------------------- queue api
    def add(self, item: Any) -> bool:
        return self.offer(item)

    def offer(self, item: Any) -> bool:
        data = dump_payload({"item": item})
        path = os.path.join(self.dir, f"{uuid.uuid4().hex}.npz")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        with self._lock:
            self._paths.append(path)
        return True

    def poll(self) -> Optional[Any]:
        """Remove and return the head, or None when empty."""
        with self._lock:
            if not self._paths:
                return None
            path = self._paths.popleft()
        with open(path, "rb") as f:
            item = load_payload(f.read())["item"]
        os.unlink(path)
        return item

    def remove(self) -> Any:
        item = self.poll()
        if item is None:
            raise IndexError("remove() on empty DiskBasedQueue")
        return item

    def peek(self) -> Optional[Any]:
        with self._lock:
            if not self._paths:
                return None
            path = self._paths[0]
        with open(path, "rb") as f:
            return load_payload(f.read())["item"]

    def element(self) -> Any:
        item = self.peek()
        if item is None:
            raise IndexError("element() on empty DiskBasedQueue")
        return item

    def size(self) -> int:
        with self._lock:
            return len(self._paths)

    def __len__(self) -> int:
        return self.size()

    def is_empty(self) -> bool:
        return self.size() == 0

    def add_all(self, items) -> bool:
        for item in items:
            self.offer(item)
        return True

    def __iter__(self) -> Iterator[Any]:
        """Drain iterator: yields and removes head-first."""
        while True:
            item = self.poll()
            if item is None:
                return
            yield item

    def clear(self) -> None:
        with self._lock:
            paths = list(self._paths)
            self._paths.clear()
        for p in paths:
            try:
                os.unlink(p)
            except OSError:
                pass

    def close(self) -> None:
        self.clear()
        shutil.rmtree(self.dir, ignore_errors=True)

    def __enter__(self) -> "DiskBasedQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
