"""Serving: the contiguous KV cache, the paged KV pool, the
continuous-batching decode loop, the fleet KV plane, the engine, the
micro-batcher, the replica set and the HTTP front end."""

from deeplearning4j_tpu_torch.serving.batcher import MicroBatcher
from deeplearning4j_tpu_torch.serving.decode_loop import (DecodeLoop,
                                                          GenerationStream)
from deeplearning4j_tpu_torch.serving.engine import (EngineStats,
                                                     InferenceEngine)
from deeplearning4j_tpu_torch.serving.errors import (Deadline,
                                                     DeadlineExceededError,
                                                     OverloadedError)
from deeplearning4j_tpu_torch.serving.replicas import ReplicaSet
from deeplearning4j_tpu_torch.serving.server import (ServingHandle,
                                                     serve_network)

__all__ = ["DecodeLoop", "GenerationStream", "EngineStats",
           "InferenceEngine", "MicroBatcher", "ReplicaSet", "ServingHandle",
           "serve_network", "Deadline", "DeadlineExceededError",
           "OverloadedError"]
