"""InferenceEngine for the transformer LM — the counterpart of the JAX
package's `serving/engine.py`, cut down to this slice's serving path.

`InferenceEngine.for_transformer(params, cfg, ...)` puts the weights on
the device (None = the CUDA device) and serves two ways:

- `generate(prompt, n_tokens)`: per-request greedy decode through the
  contiguous KV cache (`kv_cache.generate_cached`: prefill with the
  flash forward kernel, then decode steps);
- `generate_stream(prompt, max_tokens)`: the continuous-batching
  `DecodeLoop` (paged KV pool, prefill with the flash forward kernel,
  decode with the paged decode kernel; the prefix cache, decode horizon,
  speculative decoding and SLO tiers with the JAX engine's defaults),
  started by `decode_slots > 0` or `start_decode_loop`.

The bucketed `infer` forward, telemetry, hot reload and warmup plans of
the JAX engine are not part of this slice.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.models.transformer import TransformerConfig
from deeplearning4j_tpu_torch.serving.decode_loop import DecodeLoop
from deeplearning4j_tpu_torch.serving.kv_cache import generate_cached
from deeplearning4j_tpu_torch.weights import params_to_device

__all__ = ["InferenceEngine"]


class InferenceEngine:
    """A transformer LM served on one device."""

    def __init__(self, params, cfg: TransformerConfig, *, device=None):
        self.device = default_device(device)
        self.cfg = cfg
        self._params = params_to_device(params, self.device)
        #: continuous-batching slot scheduler — None until started
        self.decode_loop: Optional[DecodeLoop] = None
        self._stats = {"requests": 0, "rows": 0, "errors": 0}
        self._latency: deque = deque(maxlen=2048)  # recent generate() s

    @classmethod
    def for_transformer(cls, params, cfg: TransformerConfig, *,
                        decode_slots: int = 0, page_size: int = 16,
                        kv_pages: Optional[int] = None,
                        max_waiting: Optional[int] = None,
                        prefix_cache: bool = True,
                        decode_kernel: str = "auto", horizon: int = 1,
                        speculation: int = 0, drafter: str = "ngram",
                        draft_params=None, draft_cfg=None,
                        draft_window: int = 32, batch_share: float = 0.5,
                        batch_max_waiting: Optional[int] = None,
                        device=None, **loop_options) -> "InferenceEngine":
        """Wrap a transformer LM. `decode_slots > 0` also starts the
        `DecodeLoop`, sized by `page_size`/`kv_pages`, its admission queue
        bounded by `max_waiting`, its decode attention read chosen by
        `decode_kernel` ("auto" = the paged kernel on a CUDA device, which
        raises for a config outside the kernel's envelope; the plain
        dense gather on the CPU). `prefix_cache=False` turns off
        cross-request KV prefix sharing; `horizon > 1` chains K decode
        steps a dispatch; `speculation = k > 0` instead turns on
        draft-and-verify with `drafter` ("ngram", or "model" with
        `draft_params`/`draft_cfg`); `batch_share`/`batch_max_waiting`
        tune the batch SLO tier. `loop_options` go to `DecodeLoop`, which
        refuses the options not ported yet."""
        eng = cls(params, cfg, device=device)
        if decode_slots:
            eng.start_decode_loop(slots=decode_slots, page_size=page_size,
                                  n_pages=kv_pages, horizon=horizon,
                                  max_waiting=max_waiting,
                                  prefix_cache=prefix_cache,
                                  kernel=decode_kernel,
                                  speculation=speculation, drafter=drafter,
                                  draft_params=draft_params,
                                  draft_cfg=draft_cfg,
                                  draft_window=draft_window,
                                  batch_share=batch_share,
                                  batch_max_waiting=batch_max_waiting,
                                  **loop_options)
        return eng

    def generate(self, prompt, n_tokens: int) -> np.ndarray:
        """KV-cached greedy decode: prompt (B, T0) int tokens ->
        (B, T0 + n_tokens) numpy int32."""
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int32)
        if prompt.dim() != 2:
            raise ValueError(
                f"prompt must be (B, T0) tokens, got shape "
                f"{tuple(prompt.shape)}")
        start = time.perf_counter()
        try:
            out = generate_cached(self._params, prompt.to(self.device),
                                  self.cfg, int(n_tokens)).cpu().numpy()
        except Exception:
            self._stats["errors"] += 1
            raise
        self._stats["requests"] += 1
        self._stats["rows"] += int(prompt.shape[0])
        self._latency.append(time.perf_counter() - start)
        return out

    def start_decode_loop(self, slots: int = 8, page_size: int = 16,
                          n_pages: Optional[int] = None, horizon: int = 1,
                          max_waiting: Optional[int] = None,
                          prefix_cache: bool = True, fleet_kv: str = "off",
                          kernel: str = "auto", speculation: int = 0,
                          drafter: str = "ngram", draft_params=None,
                          draft_cfg=None, draft_window: int = 32,
                          batch_share: float = 0.5,
                          batch_max_waiting: Optional[int] = None,
                          role: str = "unified",
                          **loop_options) -> DecodeLoop:
        """Start the continuous-batching slot scheduler over a paged KV
        pool on this engine's device, with the JAX engine's options and
        defaults (`fleet_kv` stays "off" and `role` "unified": the port
        refuses the others until ROADMAP item 10e)."""
        if self.decode_loop is not None:
            raise RuntimeError("decode loop already started")
        self.decode_loop = DecodeLoop(
            self._params, self.cfg, slots=slots, page_size=page_size,
            n_pages=n_pages, horizon=horizon, max_waiting=max_waiting,
            prefix_cache=prefix_cache, fleet_kv=fleet_kv, kernel=kernel,
            speculation=speculation, drafter=drafter,
            draft_params=draft_params, draft_cfg=draft_cfg,
            draft_window=draft_window, batch_share=batch_share,
            batch_max_waiting=batch_max_waiting, role=role,
            device=self.device, **loop_options)
        return self.decode_loop

    def generate_stream(self, prompt, max_tokens: int,
                        eos_id: Optional[int] = None,
                        speculation: bool = True):
        """Submit one prompt (1-D token sequence) to the slot scheduler;
        returns a `GenerationStream`. `speculation=False` opts this
        request out of speculative drafting."""
        if self.decode_loop is None:
            raise ValueError(
                "this engine has no decode loop (pass decode_slots= to "
                "for_transformer or call start_decode_loop)")
        return self.decode_loop.submit(prompt, max_tokens, eos_id,
                                       speculation=speculation)

    def close(self) -> None:
        """Drain and stop the decode loop (no-op without one)."""
        if self.decode_loop is not None:
            self.decode_loop.close()

    def snapshot(self) -> dict:
        lat = sorted(self._latency)
        snap = dict(self._stats)
        snap["device"] = str(self.device)
        snap["latency_p50_ms"] = (lat[len(lat) // 2] * 1e3) if lat else None
        if self.decode_loop is not None:
            snap["decode"] = self.decode_loop.snapshot()
        return snap
