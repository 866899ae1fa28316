"""Drafters for speculative decoding on the deterministic decode lane — the
counterpart of the JAX package's `serving/speculation.py`.

A cheap drafter proposes k continuation tokens per slot, ONE widened
verify step (`paged_kv.paged_verify_step`) scores all k+1 positions
against the target model, and the accepted prefix is the longest run
where the draft agrees with the target's own argmax, with the first
disagreement replaced by the target's token. Output is identical to
non-speculative greedy decode by construction; only the number of target
steps per delivered token changes.

- `NgramDrafter` ("ngram") — host-only prompt lookup: the longest n-gram
  suffix of the slot's own history (prompt + everything generated so
  far) is searched backwards in that history, and on a miss in the
  corpus of recent prompts the prefix-cache trie retains
  (`PrefixIndex.iter_sequences`).
- `ModelDrafter` ("model") — a small draft transformer (its own
  `TransformerConfig` + params) proposing k greedy tokens from a fixed
  right-aligned token window through `transformer_logits`, which runs
  the flash forward kernel (K1) on the card.

A drafter only ever proposes; the decode loop's verify step is the sole
authority on what gets emitted. A bad drafter costs acceptance rate,
never correctness.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.models.transformer import transformer_logits
from deeplearning4j_tpu_torch.weights import params_to_device

__all__ = ["NgramDrafter", "ModelDrafter", "build_drafter"]


class NgramDrafter:
    """Prompt-lookup drafter: propose the continuation that followed the
    most recent earlier occurrence of the history's n-gram suffix.

    Search order per suffix length n (longest first, down to 1): the
    slot's OWN history (most recent occurrence wins), then the shared
    corpus (`corpus()` — the prefix-cache trie's retained prompt
    sequences, most recently touched first). Zero device state."""

    kind = "ngram"

    def __init__(self, ngram: int = 3,
                 corpus: Optional[Callable[[], Iterable[Sequence[int]]]]
                 = None):
        if ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {ngram}")
        self.ngram = int(ngram)
        self._corpus = corpus

    @staticmethod
    def _lookup(seq: Sequence[int], suffix: List[int],
                k: int) -> Optional[List[int]]:
        """Continuation after the most recent occurrence of `suffix` in
        `seq` that has a FULL k-token continuation; an occurrence with a
        shorter (non-empty) continuation is kept only as a fallback — a
        self-repeating tail's last occurrence has ~1 follower, one period
        earlier has k. The trivial match at the very end never fires."""
        n = len(suffix)
        best = None
        for i in range(len(seq) - n, -1, -1):
            if i + n < len(seq) and list(seq[i:i + n]) == suffix:
                cont = [int(t) for t in seq[i + n:i + n + k]]
                if len(cont) == k:
                    return cont
                if best is None:
                    best = cont
        return best

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        """Up to k proposed continuation tokens for `history` (possibly
        fewer, possibly none — the verify round simply narrows)."""
        if k < 1 or len(history) < 2:
            return []
        history = [int(t) for t in history]
        for n in range(min(self.ngram, len(history) - 1), 0, -1):
            suffix = history[-n:]
            hit = self._lookup(history, suffix, k)
            if hit:
                return hit
            if self._corpus is not None:
                for seq in self._corpus():
                    hit = self._lookup(list(seq), suffix, k)
                    if hit:
                        return hit
        return []


class ModelDrafter:
    """Small draft transformer proposing k greedy tokens per slot.

    `propose_all(windows, k)` takes the right-aligned `(S, window)` token
    batch (left zero-padding for short histories) and rolls the window k
    times through `transformer_logits`: each step takes the argmax at the
    last column and shifts it in. The left padding and window-relative
    positions only cost acceptance rate, never correctness. `device` is
    where the draft weights live (None = the CUDA device)."""

    kind = "model"

    def __init__(self, params, cfg, *, window: int = 32, device=None):
        if window < 1:
            raise ValueError(f"draft window must be >= 1, got {window}")
        self.cfg = cfg
        self.device = default_device(device)
        self.params = params_to_device(params, self.device)
        self.window = int(min(window, cfg.max_len))
        #: distinct (rows, window, k) draft shapes run
        self._shapes: set = set()
        from deeplearning4j_tpu_torch import compilecache
        #: the k-step rollout's store dispatcher with a cache active (k
        #: is static: each k is its own program), else None
        self._draft = compilecache.bind_program(
            self._rollout,
            f"draft:{compilecache.config_digest(cfg)}|w={self.window}"
            f"|dev={self.device}", static_argnums=(1,))

    @torch.no_grad()
    def _rollout(self, win: torch.Tensor, k: int) -> torch.Tensor:
        self._shapes.add((int(win.shape[0]), int(win.shape[1]), int(k)))
        out = []
        for _ in range(int(k)):
            logits = transformer_logits(self.params, win, self.cfg)
            nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
            win = torch.cat([win[:, 1:], nxt[:, None]], dim=1)
            out.append(nxt)
        return torch.stack(out, dim=1)

    def propose_all(self, windows: np.ndarray, k: int) -> np.ndarray:
        """(S, window) int32 right-aligned histories -> (S, k) int32
        proposals. Rows the caller doesn't need are computed anyway
        (fixed shape) and ignored."""
        win = torch.from_numpy(np.ascontiguousarray(windows, np.int32)) \
            .to(self.device)
        return self._run_draft(win, int(k)).cpu().numpy()

    def warm(self, rows: int, k: int) -> bool:
        """Run the `(rows, window)` k-step rollout once on zeros (warmup
        plan replay), so the first speculative round meets a warm
        program. True once the program is resident."""
        win = torch.zeros((int(rows), self.window), dtype=torch.int32,
                          device=self.device)
        self._run_draft(win, int(k))
        return True

    def _run_draft(self, win: torch.Tensor, k: int) -> torch.Tensor:
        """The rollout, through its store dispatcher when there is one."""
        if self._draft is None:
            return self._rollout(win, k)
        return self._draft(win, k)

    def draft_programs(self) -> int:
        """Distinct draft shapes run (0 until first use, then 1 under a
        fixed slot count)."""
        return len(self._shapes)

    def load_params(self, params) -> None:
        """Swap the draft weights (same single-assignment contract as the
        target's hot reload; shapes validated by the caller via
        checkpoint.restore.validate_like)."""
        self.params = params_to_device(params, self.device)


def build_drafter(drafter: str, *, k: int, cfg, draft_params=None,
                  draft_cfg=None, draft_window: int = 32, ngram: int = 3,
                  corpus=None, device=None):
    """Construct the drafter `DecodeLoop(speculation=k, drafter=...)`
    asked for, validating the pieces it needs."""
    if drafter == "ngram":
        return NgramDrafter(ngram=ngram, corpus=corpus)
    if drafter == "model":
        if draft_params is None or draft_cfg is None:
            raise ValueError(
                "drafter='model' needs draft_params= and draft_cfg= "
                "(a small TransformerConfig + its weights)")
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft model vocab_size {draft_cfg.vocab_size} != "
                f"target vocab_size {cfg.vocab_size} — proposed token "
                "ids must be target-vocabulary ids")
        return ModelDrafter(draft_params, draft_cfg, window=draft_window,
                            device=device)
    raise ValueError(
        f"drafter must be 'ngram' or 'model', got {drafter!r}")
