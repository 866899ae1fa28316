"""Object save/load helpers (reference core/util/SerializationUtils.java —
java-serialization save/read for models and datasets).

Pickle-free: the npz+JSON tree codec from scaleout/checkpoint.py handles
numpy arrays and torch tensors (written as numpy, read back as numpy),
NamedTuples registered there, and JSON-able containers — the same bytes
layout as the JAX package's `utils/serialization.py`, so either package
reads the other's files. Reading a file from shared storage can raise,
never execute code.
"""

from __future__ import annotations

from typing import Any

from deeplearning4j_tpu_torch.scaleout.checkpoint import dump_payload, load_payload


def to_bytes(obj: Any) -> bytes:
    return dump_payload({"obj": obj})


def from_bytes(data: bytes) -> Any:
    return load_payload(data)["obj"]


def save_object(obj: Any, path: str) -> str:
    """reference SerializationUtils.saveObject(Serializable, File)."""
    with open(path, "wb") as f:
        f.write(to_bytes(obj))
    return path


def read_object(path: str) -> Any:
    """reference SerializationUtils.readObject(File)."""
    with open(path, "rb") as f:
        return from_bytes(f.read())
