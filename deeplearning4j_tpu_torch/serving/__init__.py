"""Serving: the contiguous KV cache, the paged KV pool, the
continuous-batching decode loop, the fleet KV plane, the engine, the
micro-batcher, the replica set, the HTTP front end, and the fleet with
its router over out-of-process replica servers."""

from deeplearning4j_tpu_torch.serving.batcher import MicroBatcher
from deeplearning4j_tpu_torch.serving.decode_loop import (DecodeLoop,
                                                          GenerationStream)
from deeplearning4j_tpu_torch.serving.engine import (EngineStats,
                                                     InferenceEngine)
from deeplearning4j_tpu_torch.serving.errors import (Deadline,
                                                     DeadlineExceededError,
                                                     OverloadedError)
from deeplearning4j_tpu_torch.serving.fleet import (Autoscaler,
                                                    CircuitBreaker, Fleet,
                                                    FleetReplica,
                                                    NoReadyReplicas,
                                                    ReplicaSpawner)
from deeplearning4j_tpu_torch.serving.kv_cache import (KVCache, decode_step,
                                                      generate_cached,
                                                      init_cache,
                                                      kv_cache_bytes,
                                                      prefill)
from deeplearning4j_tpu_torch.serving.paged_kv import (PagedKVPool,
                                                      init_paged_pool,
                                                      paged_decode_step,
                                                      paged_kv_bytes,
                                                      paged_prefill)
from deeplearning4j_tpu_torch.serving.replicas import ReplicaSet
from deeplearning4j_tpu_torch.serving.router import (FleetHandle,
                                                     ReplicaClient,
                                                     serve_fleet)
from deeplearning4j_tpu_torch.serving.server import (ServingHandle,
                                                     serve_network)

__all__ = ["DecodeLoop", "GenerationStream", "EngineStats",
           "InferenceEngine", "MicroBatcher", "ReplicaSet", "ServingHandle",
           "serve_network", "Deadline", "DeadlineExceededError",
           "OverloadedError", "Autoscaler", "CircuitBreaker", "Fleet",
           "FleetReplica", "NoReadyReplicas", "ReplicaSpawner",
           "FleetHandle", "ReplicaClient", "serve_fleet", "KVCache",
           "decode_step", "generate_cached", "init_cache", "kv_cache_bytes",
           "prefill", "PagedKVPool", "init_paged_pool", "paged_decode_step",
           "paged_kv_bytes", "paged_prefill"]
