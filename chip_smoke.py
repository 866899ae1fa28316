#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to their
plain versions.

    python3 chip_smoke.py [--seed N] [--out chiprun_out/chip_smoke.json]

Phases, each printing one JSON line (any failure exits non-zero and
prints no result):

1. env          — the card (nvidia-smi name and power limit), torch and
                  CUDA versions; the card must be compute capability 9.0
                  (Hopper).
2. build        — build the kernels from deeplearning4j_tpu_torch/csrc/.
3. kernels      — every ported kernel against its plain PyTorch version on
                  the card: the flash forward (K1) at B*H = 64, T in
                  {16, 100, 128, 1024} and Tq < Tk, hd 64 and 128, causal
                  or not; the paged decode (K4) at 8 slots, page_size 16,
                  64 pages per slot, ragged cursors (0, ps-1, ps, the
                  window edge, past it) and an idle all-trash slot.
                  float32 within 2e-5, bfloat16 within 2e-2 (unit-scale
                  inputs; the summation order differs). The float32 flash
                  cases are also held against blockwise_attention, the
                  online-softmax plain form. Then the flash backward, dQ
                  (K2) and dK/dV (K3), with an lse cotangent, at the same
                  B*H, hd, causal settings and shapes plus Tq > Tk (rows
                  that see no key): within 1e-4 (float32) and 3e-2
                  (bfloat16) of the largest |plain| value, and in float32
                  also against torch.autograd.grad of blockwise_attention.
4. parity       — the model at full width (d_model 1024, 8 heads, d_ff
                  4096, vocab 8192) cut to 2 layers, float32:
                  teacher-forced batched prefill logits and 8 decode-step
                  logits on the card (kernels) against the same weights on
                  the CPU (plain versions), within 1e-3.
5. serve        — the serving path at full width: the 8-layer
                  110M-parameter LM in bfloat16 behind
                  InferenceEngine.for_transformer(..., decode_slots=8,
                  page_size=16), 16 requests with prompt lengths in
                  [16, 768] drawn from the seed, 64 new tokens each. Every
                  stream must finish, every page must come back, and both
                  kernels must have been launched on this path.
6. train_parity — full width cut to 2 layers, float32, 2 x 301 tokens:
                  lm_loss and every gradient leaf on the card (K1 with its
                  lse, K2, K3) against the same weights on the CPU (plain
                  versions), then the params after 2 make_train_step
                  steps; limits in TRAIN_PARITY_TOL.
7. train        — the training path at full width: the 8-layer 110M bf16
                  LM at B 8 x 1025 tokens (T 1024 reaches the model) on a
                  cyclic, learnable token sequence: TRAIN_STEPS
                  make_train_step steps, then fit_scan over the batches.
                  Every loss finite, the last step's loss and fit_scan's
                  below half the first step's, and K1, K2 and K3 each
                  launched exactly n_layers times a step (counted).
                  Tokens/s and step ms by CUDA events.

Then, at each path's shapes: each kernel's time beside its plain
version's, the library call's (SDPA for K1, SDPA's backward for K2 + K3)
and its bound, one whole prefill, decode step and training step, each
profiled. The last lines are the card as nvidia-smi gives it, the
kernels' JSON line, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import _build
from deeplearning4j_tpu_torch.attention import blockwise, flash, paged
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, fit_scan, init_transformer_params, init_velocity,
    lm_loss_and_grads, make_train_step)
from deeplearning4j_tpu_torch.serving import paged_kv
from deeplearning4j_tpu_torch.serving.engine import InferenceEngine
from deeplearning4j_tpu_torch.weights import params_to_device

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: K2/K3 against their plain version, relative to the largest |plain|
#: value: float32 sums in another order; bfloat16 P and dS round at the
#: same points, but a value near a rounding edge may round the other way
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
#: the 110M LM (d_model 1024, 8 layers, hd 128, vocab 8192, bf16)
FULL = TransformerConfig(vocab_size=8192, d_model=1024, n_heads=8,
                         n_layers=8, d_ff=4096, max_len=1024,
                         dtype=torch.bfloat16)
SLOTS, PAGE_SIZE, N_REQUESTS, MAX_TOKENS = 8, 16, 16, 64
#: the training path: B x (T + 1) tokens a batch, steps, batches, lr
#: (at lr 0.01 and above, SGD with momentum 0.9 overshoots on this data
#: after 3 steps and the loss climbs again)
TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_BATCHES, TRAIN_LR = 8, 1024, 10, 4, 5e-3
#: card vs CPU, float32, 2 layers: the loss (absolute; it is ~9), each
#: gradient leaf (relative to its largest |CPU| value; sums in another
#: order, the tied embedding's a scatter-add with atomics), the params
#: after 2 steps (absolute; parameters are ~0.02)
TRAIN_PARITY_TOL = {"loss": 2e-5, "grad": 1e-4, "embed_grad": 1e-4,
                    "params": 2e-6}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Per-call device time with CUDA events, the 50 MB L2 flushed before
    each call so every input is read from device memory, as the serving
    loop finds it."""

    def __init__(self, device):
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, iters: int = 10) -> float:
        fn()  # warm up
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(count_params(v) for v in tree)
    return tree.numel()


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


# ----------------------------------------------------------------- bounds
def visible_pairs(tq, tk, causal):
    """(query, key) pairs one batch*head row attends over."""
    if not causal:
        return tq * tk
    off = tk - tq
    return sum(max(0, min(tk, i + off + 1)) for i in range(tq))


def flash_work(bh, tq, tk, hd, causal, dtype):
    """(bytes, operations) the flash forward must move and do: q, k, v
    read once and out written once; 4*hd operations per visible
    (query, key) pair (two products of 2*hd)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = bh * (2 * tq + 2 * tk) * hd * itemsize
    return nbytes, 4 * hd * bh * visible_pairs(tq, tk, causal)


def flash_bwd_work(kernel, bh, tq, tk, hd, causal, dtype):
    """(bytes, operations) of one backward kernel. Both read q, dO (Tq
    rows), k, v (Tk rows) and the float32 lse and D once. K2 ("dq")
    writes dQ and does 6*hd operations per visible pair (S, dP, dS.K);
    K3 ("dkv") writes dK and dV and does 8*hd (S, dP, P^T.dO, dS^T.Q)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    rows = {"dq": 3 * tq + 2 * tk, "dkv": 2 * tq + 4 * tk}[kernel]
    nbytes = bh * rows * hd * itemsize + bh * tq * 2 * 4
    per_pair = {"dq": 6, "dkv": 8}[kernel] * hd
    return nbytes, per_pair * bh * visible_pairs(tq, tk, causal)


def paged_work(lengths, heads, hd, ps, width, dtype):
    """(bytes, operations) of one paged decode call: the written pages of
    K and V read once (the pages these cursors reach), q read and out
    written once, plus the table row and cursor; 4*hd operations per
    visible position."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    pages = sum(min(int(p) // ps + 1, width) for p in lengths)
    nbytes = (2 * pages * heads * ps * hd * itemsize
              + 2 * len(lengths) * heads * hd * itemsize
              + len(lengths) * (width + 1) * 4)
    positions = sum(min(int(p) + 1, width * ps) for p in lengths)
    return nbytes, 4 * hd * heads * positions


def bound_ms(nbytes, ops, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------------ cases
def paged_inputs(gen, device, dtype, heads, hd, lengths, n_pages=512,
                 ps=PAGE_SIZE, width=64):
    """A pool and page tables with each slot's written pages scattered
    over the pool; an idle slot (cursor 0, last row) keeps an all-trash
    table."""
    s = len(lengths)
    trash = n_pages
    q = torch.randn(s, heads, hd, generator=gen).to(device, dtype)
    kp = torch.randn(n_pages + 1, heads, ps, hd, generator=gen).to(device,
                                                                  dtype)
    vp = torch.randn(n_pages + 1, heads, ps, hd, generator=gen).to(device,
                                                                  dtype)
    perm = torch.randperm(n_pages, generator=gen).tolist()
    table = torch.full((s, width), trash, dtype=torch.int32)
    nxt = 0
    for i, pos in enumerate(lengths[:-1]):
        for j in range(min(int(pos) // ps + 1, width)):
            table[i, j] = perm[nxt % n_pages]
            nxt += 1
    lens = torch.tensor(lengths, dtype=torch.int32)
    return q, kp, vp, table.to(device), lens.to(device)


def phase_kernels(device, timer, seed):
    gen = torch.Generator().manual_seed(seed)
    cases, worst = [], {"flash_fwd": 0.0, "paged_decode": 0.0}
    shapes = [(t, t) for t in (16, 100, 128, 1024)] + [(64, 1024)]
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (64, 128):
            for tq, tk in shapes:
                q = torch.randn(64, tq, hd, generator=gen).to(device, dtype)
                k = torch.randn(64, tk, hd, generator=gen).to(device, dtype)
                v = torch.randn(64, tk, hd, generator=gen).to(device, dtype)
                for causal in (False, True):
                    out, lse = flash.flash_attention_with_lse(q, k, v,
                                                              causal)
                    ref, ref_lse = flash.flash_attention_ref(q, k, v, causal,
                                                             True)
                    torch.cuda.synchronize()
                    err = max_err(out, ref)
                    lse_err = max_err(lse, ref_lse)
                    ok = err <= TOL[dtype] and lse_err <= 1e-3
                    bw_err = None
                    if dtype == torch.float32:
                        # the online-softmax plain form, natural base
                        bw, bw_lse = blockwise.blockwise_attention(
                            q, k, v, causal, block_size=64, return_lse=True)
                        bw_err = max_err(out, bw)
                        ok = (ok and bw_err <= TOL[dtype]
                              and max_err(lse, bw_lse) <= 1e-3)
                    cases.append({
                        "kernel": "flash_fwd", "dtype": str(dtype),
                        "bh": 64, "tq": tq, "tk": tk, "hd": hd,
                        "causal": causal, "max_abs_err": err,
                        "lse_max_abs_err": lse_err,
                        "blockwise_max_abs_err": bw_err, "ok": ok,
                        "kernel_ms": timer.ms(
                            lambda: flash.flash_attention(q, k, v, causal),
                            iters=5),
                        "ref_ms": timer.ms(
                            lambda: flash.flash_attention_ref(q, k, v,
                                                              causal),
                            iters=3)})
                    worst["flash_fwd"] = max(worst["flash_fwd"], err)
                    if not ok:
                        raise AssertionError(f"flash kernel disagrees: "
                                             f"{cases[-1]}")
    window = 64 * PAGE_SIZE
    lengths = [0, PAGE_SIZE - 1, PAGE_SIZE, 345, window - 1, window, 700, 0]
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (64, 128):
            args = paged_inputs(gen, device, dtype, 8, hd, lengths)
            out = paged.paged_attention(*args)
            ref = paged.paged_attention_ref(*args)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            cases.append({
                "kernel": "paged_decode", "dtype": str(dtype), "slots": 8,
                "heads": 8, "hd": hd, "page_size": PAGE_SIZE,
                "table_width": 64, "lengths": lengths,
                "max_abs_err": err, "ok": err <= TOL[dtype],
                "kernel_ms": timer.ms(lambda: paged.paged_attention(*args)),
                "ref_ms": timer.ms(lambda: paged.paged_attention_ref(*args),
                                   iters=3)})
            worst["paged_decode"] = max(worst["paged_decode"], err)
            if err > TOL[dtype]:
                raise AssertionError(f"paged kernel disagrees: {cases[-1]}")
    bwd, bwd_worst = bwd_cases(device, timer, gen)
    return cases + bwd, {**worst, **bwd_worst}


def rel_errs(got, ref):
    """max |got - ref| and that over max |ref|, per tensor."""
    out = []
    for a, b in zip(got, ref):
        err = max_err(a, b)
        out.append((err, err / max(float(b.float().abs().max()), 1e-30)))
    return out


def bwd_cases(device, timer, gen):
    """K2 and K3 (through `_flash_backward`, with an lse cotangent)
    against `flash_attention_bwd_ref` on the card; float32 also against
    autograd of blockwise_attention."""
    cases = []
    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
             "flash_bwd_dq_rel": 0.0, "flash_bwd_dkv_rel": 0.0}
    shapes = ([(t, t) for t in (16, 100, 128, 1024)]
              + [(64, 1024), (200, 37)])
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (64, 128):
            for tq, tk in shapes:
                q, do = (torch.randn(64, tq, hd, generator=gen)
                         .to(device, dtype) for _ in range(2))
                k, v = (torch.randn(64, tk, hd, generator=gen)
                        .to(device, dtype) for _ in range(2))
                g_lse = torch.randn(64, tq, generator=gen).to(device)
                for causal in (False, True):
                    out, lse = flash.flash_attention_with_lse(q, k, v,
                                                              causal)
                    args = (q, k, v, out, lse, do, causal, g_lse)
                    got = flash._flash_backward(*args)
                    ref = flash.flash_attention_bwd_ref(*args)
                    errs = rel_errs(got, ref)
                    ok = max(r for _, r in errs) <= BWD_TOL[dtype]
                    # rows that see no key (causal Tq > Tk): exactly zero
                    no_key = max(tq - tk, 0) if causal else 0
                    no_key_zero = bool((got[0][:, :no_key] == 0).all())
                    ok = ok and no_key_zero
                    bw_rel = None
                    if dtype == torch.float32:
                        leaves = [x.detach().requires_grad_()
                                  for x in (q, k, v)]
                        bw = torch.autograd.grad(
                            blockwise.blockwise_attention(
                                *leaves, causal, block_size=64,
                                return_lse=True), leaves, (do, g_lse))
                        bw_rel = max(r for _, r in rel_errs(got, bw))
                        ok = ok and bw_rel <= BWD_TOL[dtype]
                    torch.cuda.synchronize()
                    cases.append({
                        "kernel": "flash_bwd", "dtype": str(dtype),
                        "bh": 64, "tq": tq, "tk": tk, "hd": hd,
                        "causal": causal,
                        "max_abs_err": {n: e for n, (e, _) in
                                        zip(("dq", "dk", "dv"), errs)},
                        "max_rel_err": {n: r for n, (_, r) in
                                        zip(("dq", "dk", "dv"), errs)},
                        "blockwise_max_rel_err": bw_rel,
                        "no_key_rows": no_key,
                        "no_key_rows_dq_zero": no_key_zero, "ok": ok,
                        "kernel_ms": timer.ms(
                            lambda: flash._flash_backward(*args), iters=3),
                        "ref_ms": timer.ms(
                            lambda: flash.flash_attention_bwd_ref(*args),
                            iters=2)})
                    for name, idx in (("flash_bwd_dq", (0,)),
                                      ("flash_bwd_dkv", (1, 2))):
                        worst[name] = max(worst[name],
                                          *(errs[i][0] for i in idx))
                        worst[name + "_rel"] = max(
                            worst[name + "_rel"], *(errs[i][1] for i in idx))
                    if not ok:
                        raise AssertionError(f"flash backward kernels "
                                             f"disagree: {cases[-1]}")
    return cases, worst


def phase_parity(device, seed):
    """Full width cut to 2 layers, float32: card (kernels) vs CPU (plain
    versions) on the same weights."""
    cfg = FULL._replace(n_layers=2, dtype=torch.float32)
    params = init_transformer_params(seed, cfg, device=device)
    cpu_params = params_to_device(params, "cpu")
    rng = np.random.default_rng(seed)
    lens = [37, 100, 16]
    tb, slots, n_pages = 128, 4, 64
    pps = paged_kv.pages_per_slot(cfg, PAGE_SIZE)
    toks = np.zeros((slots, tb), np.int32)
    true_len = np.ones((slots,), np.int32)      # row 3 is padding
    page_ids = np.full((slots, tb // PAGE_SIZE), n_pages, np.int32)
    table = np.full((slots, pps), n_pages, np.int32)
    nxt = 0
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
        true_len[i] = n
        own = list(range(nxt, nxt + paged_kv.pages_for_tokens(n + 8,
                                                              PAGE_SIZE)))
        nxt += len(own)
        page_ids[i, :paged_kv.pages_for_tokens(n, PAGE_SIZE)] = \
            own[:paged_kv.pages_for_tokens(n, PAGE_SIZE)]
        table[i, :len(own)] = own
    steps = rng.integers(0, cfg.vocab_size, (8, slots)).astype(np.int32)
    active = np.array([True, True, True, False])
    results = {}
    for where, dev, p in (("card", device, params),
                          ("cpu", torch.device("cpu"), cpu_params)):
        def t(a, dtype=None):
            x = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            return x if dtype is None else x.to(dtype)
        pool = paged_kv.init_paged_pool(cfg, n_pages, PAGE_SIZE, device=dev)
        logits, pool = paged_kv.paged_prefill(p, t(toks), t(true_len), pool,
                                              t(page_ids), cfg)
        out = [logits[:3].float().cpu()]
        lengths = np.array(lens + [0], np.int32)
        for s in range(8):
            logits, pool = paged_kv.paged_decode_step(
                p, t(steps[s]), pool, t(table), t(lengths), t(active), cfg,
                kernel="kernel")
            out.append(logits[:3].float().cpu())
            lengths = lengths + active.astype(np.int32)
        results[where] = torch.stack(out)
    torch.cuda.synchronize()
    diff = max_err(results["card"], results["cpu"])
    finite = bool(torch.isfinite(results["card"]).all())
    return {"layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab_size, "dtype": "float32",
            "prompt_lengths": lens, "decode_steps": 8,
            "logits_max_abs_diff": diff, "logit_scale": float(
                results["cpu"].abs().max()), "finite": finite,
            "ok": finite and diff <= 1e-3}


def phase_serve(device, seed):
    params = init_transformer_params(seed, FULL, device=device)
    n_params = count_params(params)
    rng = np.random.default_rng(seed)
    plens = rng.integers(16, 769, N_REQUESTS).tolist()
    prompts = [rng.integers(0, FULL.vocab_size, n).tolist() for n in plens]
    eng = InferenceEngine.for_transformer(params, FULL,
                                          decode_slots=SLOTS,
                                          page_size=PAGE_SIZE,
                                          device=device)
    try:
        loop = eng.decode_loop
        torch.cuda.synchronize()
        flash.launches = 0
        paged.launches = 0
        t0 = time.perf_counter()
        streams = [eng.generate_stream(p, MAX_TOKENS) for p in prompts]
        outs = [s.result(timeout=600) for s in streams]
        wall = time.perf_counter() - t0
        launches = {"flash_fwd": flash.launches,
                    "paged_decode": paged.launches}
        snap = loop.snapshot()
        steps = sorted(loop.step_seconds)
        ok = (all(s.finish_reason == "max_tokens" for s in streams)
              and all(len(o) == MAX_TOKENS for o in outs)
              and all(0 <= t < FULL.vocab_size for o in outs for t in o)
              and snap["pages_in_use"] == 0
              and snap["pages_free"] == loop.n_pages
              and launches["flash_fwd"] > 0 and launches["paged_decode"] > 0
              and snap["decode_kernel"]["selected"] == "kernel")
        # the engine's other entry point: per-request KV-cached generate
        gen_out = eng.generate(np.array([prompts[0][:32]]), 8)
        ok = ok and gen_out.shape == (1, 40)
    finally:
        eng.close()
    generated = sum(len(o) for o in outs)
    return {"params": n_params, "layers": FULL.n_layers,
            "d_model": FULL.d_model, "heads": FULL.n_heads,
            "vocab": FULL.vocab_size, "dtype": "bfloat16",
            "slots": SLOTS, "page_size": PAGE_SIZE,
            "n_pages": loop.n_pages, "requests": N_REQUESTS,
            "prompt_lengths": plens, "max_tokens": MAX_TOKENS,
            "generated_tokens": generated, "wall_s": wall,
            "tokens_per_s": generated / wall,
            "decode_steps": len(steps),
            "decode_step_ms_p50": steps[len(steps) // 2] * 1e3,
            "decode_step_ms_mean": sum(steps) / len(steps) * 1e3,
            "prefill_groups": snap["prefill_groups"],
            "launches": launches, "peak_pages_in_use":
                snap["peak_pages_in_use"], "ok": ok}, params, plens


def flash_counts() -> dict:
    return {"flash_fwd": flash.launches, "flash_bwd_dq": flash.dq_launches,
            "flash_bwd_dkv": flash.dkv_launches}


def reset_flash_counts() -> None:
    flash.launches = flash.dq_launches = flash.dkv_launches = 0


def leaf_items(tree, prefix=""):
    """(path, tensor) for every leaf of a params-shaped tree."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in leaf_items(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree)
                for kv in leaf_items(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def cyclic_tokens(seed, n_batches, b, t, period=5):
    """tokens[i] = (offset + i) % period, a random offset per row: a
    learnable sequence (the JAX package's tests/test_transformer.py
    builds its training data the same way)."""
    off = np.random.RandomState(seed).randint(0, period, (n_batches, b, 1))
    return torch.from_numpy(((off + np.arange(t)[None, None, :]) % period)
                            .astype(np.int32))


def phase_train_parity(device, seed):
    """Full width cut to 2 layers, float32: the loss, every gradient leaf
    and the params after 2 train steps on the card (kernels) against the
    same weights on the CPU (plain versions), at a ragged T."""
    cfg = FULL._replace(n_layers=2, dtype=torch.float32)
    params = init_transformer_params(seed, cfg, device=device)
    cpu_params = params_to_device(params, "cpu")
    rng = np.random.default_rng(seed + 2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 2, 301))
                            .astype(np.int32))
    torch.cuda.synchronize()
    reset_flash_counts()
    loss, grads = lm_loss_and_grads(params, toks[0].to(device), cfg)
    torch.cuda.synchronize()
    launches = flash_counts()
    cpu_loss, cpu_grads = lm_loss_and_grads(cpu_params, toks[0], cfg)
    grad_rel = {}
    for (name, g), (_, cg) in zip(leaf_items(grads), leaf_items(cpu_grads)):
        grad_rel[name] = max_err(g.cpu(), cg) / max(
            float(cg.abs().max()), 1e-30)
    embed_rel = grad_rel.pop("/embed")
    zero_leaves = [n for n, g in leaf_items(grads)
                   if float(g.abs().max()) == 0.0]
    step, cpu_step = make_train_step(cfg), make_train_step(cfg)
    vel, cpu_vel = init_velocity(params), init_velocity(cpu_params)
    for tok in toks[1:]:
        params, vel, _ = step(params, vel, tok.to(device))
        cpu_params, cpu_vel, _ = cpu_step(cpu_params, cpu_vel, tok)
    param_diff = max(max_err(a.cpu(), b) for (_, a), (_, b) in
                     zip(leaf_items(params), leaf_items(cpu_params)))
    loss_diff = abs(float(loss) - float(cpu_loss))
    worst_leaf = max(grad_rel, key=grad_rel.get)
    tol = TRAIN_PARITY_TOL
    ok = (loss_diff <= tol["loss"] and grad_rel[worst_leaf] <= tol["grad"]
          and embed_rel <= tol["embed_grad"]
          and param_diff <= tol["params"] and not zero_leaves
          and launches == {k: cfg.n_layers for k in launches})
    return {"layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab_size, "dtype": "float32",
            "tokens": list(toks.shape[1:]), "loss": float(loss),
            "loss_abs_diff": loss_diff,
            "grad_max_rel_diff": grad_rel[worst_leaf],
            "grad_worst_leaf": worst_leaf,
            "embed_grad_rel_diff": embed_rel,
            "params_after_2_steps_max_abs_diff": param_diff,
            "leaves_with_zero_grad": zero_leaves,
            "launches_one_loss_and_grad": launches,
            "tolerances": tol, "ok": ok}


def phase_train(device, seed):
    """The training path at full width: TRAIN_STEPS make_train_step
    steps, then fit_scan over the batches."""
    params = init_transformer_params(seed, FULL, device=device)
    batches = cyclic_tokens(seed, TRAIN_BATCHES, TRAIN_B,
                            TRAIN_T + 1).to(device)
    step = make_train_step(FULL, lr=TRAIN_LR)
    velocity = init_velocity(params)
    torch.cuda.synchronize()
    reset_flash_counts()
    losses, events = [], []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, velocity, loss = step(params, velocity,
                                      batches[i % TRAIN_BATCHES])
        end.record()
        losses.append(loss)
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_launches = flash_counts()
    losses = torch.stack(losses).tolist()
    step_ms = [a.elapsed_time(b) for a, b in events]
    t0 = time.perf_counter()
    params, last = fit_scan(params, batches, FULL, lr=TRAIN_LR)
    last = float(last)
    fit_s = time.perf_counter() - t0
    launches = flash_counts()
    per_step = FULL.n_layers
    ok = (all(np.isfinite(losses)) and np.isfinite(last)
          and max(losses[-1], last) < 0.5 * losses[0]
          and step_launches == {k: per_step * TRAIN_STEPS
                                for k in step_launches}
          and launches == {k: per_step * (TRAIN_STEPS + TRAIN_BATCHES)
                           for k in launches})
    tokens_per_step = TRAIN_B * TRAIN_T
    steady = sorted(step_ms[1:])
    return {"params": count_params(params), "layers": FULL.n_layers,
            "d_model": FULL.d_model, "heads": FULL.n_heads,
            "vocab": FULL.vocab_size, "dtype": "bfloat16",
            "batch": TRAIN_B, "tokens_per_row": TRAIN_T + 1,
            "lr": TRAIN_LR, "steps": TRAIN_STEPS, "losses": losses,
            "fit_scan_batches": TRAIN_BATCHES, "fit_scan_last_loss": last,
            "fit_scan_s": fit_s, "step_ms": step_ms,
            "step_ms_p50": steady[len(steady) // 2],
            "tokens_per_s": tokens_per_step * TRAIN_STEPS / wall,
            "tokens_per_s_p50_step": tokens_per_step / (
                steady[len(steady) // 2] / 1e3),
            "launches_steps": step_launches, "launches": launches,
            "ok": ok}, params, batches


def train_timing(device, timer, params, batches, seed, worst, launches):
    """K1 (with its lse), K2 and K3 at the training path's attention shape
    beside their plain version, the library call and their bound; one
    whole training step, timed and profiled."""
    gen = torch.Generator().manual_seed(seed + 3)
    dt = FULL.dtype
    hd = FULL.d_model // FULL.n_heads
    bh, t = TRAIN_B * FULL.n_heads, TRAIN_T
    q, k, v, do = (torch.randn(TRAIN_B, FULL.n_heads, t, hd, generator=gen)
                   .to(device, dt) for _ in range(4))
    q3, k3, v3, do3 = (x.reshape(bh, t, hd) for x in (q, k, v, do))
    out, lse = flash.flash_attention_with_lse(q3, k3, v3, True)
    dd = flash._delta(out, do3).contiguous()
    args = (q3, k3, v3, out, lse, do3, True)
    errs = rel_errs(flash._flash_backward(*args),
                    flash.flash_attention_bwd_ref(*args))
    if max(r for _, r in errs) > BWD_TOL[dt]:
        raise AssertionError(f"flash backward disagrees at the training "
                             f"shape: {errs}")
    plain_ms = timer.ms(lambda: flash.flash_attention_bwd_ref(*args),
                        iters=5)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    library_ms = timer.ms(lambda: torch.autograd.grad(
        sdpa_out, leaves, do, retain_graph=True))
    shape = {"bh": bh, "t": t, "hd": hd, "dtype": "bfloat16",
             "causal": True}
    rows = []
    for name, fn, idx in (
            ("dq", lambda: flash._launch_dq(q3, k3, v3, do3, lse, dd, True),
             (0,)),
            ("dkv", lambda: flash._launch_dkv(q3, k3, v3, do3, lse, dd, True),
             (1, 2))):
        key = f"flash_bwd_{name}"
        nbytes, ops = flash_bwd_work(name, bh, t, t, hd, True, dt)
        bound, by = bound_ms(nbytes, ops, dt)
        rows.append({
            "name": key, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/flash_bwd.cu",
            "replaces": {"dq": "deeplearning4j_tpu/attention/"
                               "flash_pallas.py:312",
                         "dkv": "deeplearning4j_tpu/attention/"
                                "flash_pallas.py:375"}[name],
            "launches": launches[key],
            "max_abs_err": max(worst[key], *(errs[i][0] for i in idx)),
            "max_rel_err": max(worst[key + "_rel"],
                               *(errs[i][1] for i in idx)),
            "ms": timer.ms(fn), "plain_ms": plain_ms,
            "plain_covers": "dQ, dK and dV together",
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms,
            "library_covers": "SDPA backward: dQ, dK and dV together",
            "shape": shape})
    nbytes, ops = flash_work(bh, t, t, hd, True, dt)
    k1_bound, k1_by = bound_ms(nbytes, ops, dt)
    k1_train = {"ms": timer.ms(lambda: flash.flash_attention_with_lse(
                    q3, k3, v3, True)),
                "bound_ms": k1_bound, "bound_by": k1_by,
                "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True)), "shape": shape,
                "with_lse": True}
    step = make_train_step(FULL, lr=TRAIN_LR)
    velocity = init_velocity(params)

    def one_step():
        return step(params, velocity, batches[0])

    groups = {"flash_fwd": "flash_fwd_kernel",
              "flash_bwd_dq": "flash_bwd_dq_kernel",
              "flash_bwd_dkv": "flash_bwd_dkv_kernel",
              "cublas_gemm": "nvjet", "elementwise": "elementwise_kernel",
              "reduce": "reduce_kernel"}
    return rows, {
        "train_shape_flash_fwd": k1_train,
        "train_step_ms": timer.ms(one_step, iters=3),
        "train_step_profile": device_profile(one_step, iters=2,
                                             groups=groups)}


def main_path_timing(device, timer, params, plens, serve, seed, worst,
                     launches):
    """Each kernel at the shapes the serve phase gave it, beside its plain
    version, the library call and its bound; plus one whole prefill and
    one whole decode step of the 8-layer model."""
    gen = torch.Generator().manual_seed(seed + 1)
    dt = FULL.dtype
    hd = FULL.d_model // FULL.n_heads
    # K1: the prefill group with the most attention work
    bb, tb = max(serve["prefill_groups"], key=lambda g: g[0] * g[1] ** 2)
    bh = bb * FULL.n_heads
    q, k, v = (torch.randn(bb, FULL.n_heads, tb, hd, generator=gen)
               .to(device, dt) for _ in range(3))
    q3, k3, v3 = (x.reshape(bh, tb, hd) for x in (q, k, v))
    f_err = max_err(flash.flash_attention(q3, k3, v3, True),
                    flash.flash_attention_ref(q3, k3, v3, True))
    nbytes, ops = flash_work(bh, tb, tb, hd, True, dt)
    f_bound, f_by = bound_ms(nbytes, ops, dt)
    k1 = {"name": "flash_fwd", "route": "cuda",
          "source": "deeplearning4j_tpu_torch/csrc/flash_fwd.cu",
          "replaces": "deeplearning4j_tpu/attention/flash_pallas.py:92",
          "launches": launches["flash_fwd"],
          "max_abs_err": max(worst["flash_fwd"], f_err),
          "ms": timer.ms(lambda: flash.flash_attention(q3, k3, v3, True)),
          "plain_ms": timer.ms(lambda: flash.flash_attention_ref(
              q3, k3, v3, True), iters=5),
          "bound_ms": f_bound, "bound_by": f_by,
          "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
              q, k, v, is_causal=True)),
          "shape": {"bh": bh, "t": tb, "hd": hd, "dtype": "bfloat16",
                    "causal": True}}
    # K4: the decode step with 8 slots mid-generation (cursor = prompt +
    # 32 tokens), on a pool the size of the serve phase's
    lengths = [p + 32 for p in plens[:SLOTS]]
    width = paged_kv.pages_per_slot(FULL, PAGE_SIZE)
    args = paged_inputs(gen, device, dt, FULL.n_heads, hd, lengths + [0],
                        n_pages=serve["n_pages"], width=width)
    args = (args[0][:SLOTS].contiguous(), args[1], args[2],
            args[3][:SLOTS].contiguous(), args[4][:SLOTS].contiguous())
    p_err = max_err(paged.paged_attention(*args),
                    paged.paged_attention_ref(*args))
    nbytes, ops = paged_work(lengths, FULL.n_heads, hd, PAGE_SIZE, width, dt)
    p_bound, p_by = bound_ms(nbytes, ops, dt)
    k4 = {"name": "paged_decode", "route": "cuda",
          "source": "deeplearning4j_tpu_torch/csrc/paged_decode.cu",
          "replaces": "deeplearning4j_tpu/attention/paged_pallas.py:51",
          "launches": launches["paged_decode"],
          "max_abs_err": max(worst["paged_decode"], p_err),
          "ms": timer.ms(lambda: paged.paged_attention(*args)),
          "plain_ms": timer.ms(lambda: paged.paged_attention_ref(*args),
                               iters=5),
          "bound_ms": p_bound, "bound_by": p_by, "library_ms": None,
          "shape": {"slots": SLOTS, "heads": FULL.n_heads, "hd": hd,
                    "page_size": PAGE_SIZE, "table_width": width,
                    "lengths": lengths, "dtype": "bfloat16"}}
    if max(f_err, p_err) > TOL[dt]:
        raise AssertionError(f"kernel disagrees at main-path shapes: "
                             f"flash {f_err}, paged {p_err}")
    # whole-model steps at the same shapes
    n_pages = serve["n_pages"]
    pool = paged_kv.init_paged_pool(FULL, n_pages, PAGE_SIZE, device=device)
    toks = torch.randint(0, FULL.vocab_size, (bb, tb), generator=gen,
                         dtype=torch.int32).to(device)
    tl = torch.full((bb,), tb, dtype=torch.int32, device=device)
    pids = torch.arange(bb * tb // PAGE_SIZE, dtype=torch.int32,
                        device=device).reshape(bb, -1) % n_pages
    prefill_ms = timer.ms(lambda: paged_kv.paged_prefill(
        params, toks, tl, pool, pids, FULL), iters=3)
    dtok = torch.randint(0, FULL.vocab_size, (SLOTS,), generator=gen,
                         dtype=torch.int32).to(device)
    active = torch.ones(SLOTS, dtype=torch.bool, device=device)
    def step():
        return paged_kv.paged_decode_step(params, dtok, pool, args[3],
                                          args[4], active, FULL,
                                          kernel="kernel")

    step_ms = timer.ms(step, iters=5)
    return [k1, k4], {
        "prefill_group": [bb, tb], "prefill_ms": prefill_ms,
        "decode_step_ms": step_ms,
        "decode_step_profile": device_profile(step, iters=5),
        "prefill_profile": device_profile(lambda: paged_kv.paged_prefill(
            params, toks, tl, pool, pids, FULL), iters=2)}


def device_profile(fn, iters: int, groups=None) -> dict:
    """Device time by kernel over `iters` calls (torch.profiler, CUDA
    activity only counted from kernel events), and the device's busy
    share of the profiled wall time; `groups` ({label: substring of the
    kernel name}) adds each group's share and calls. "not measured" when
    the profiler reports no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(ev.key, ev.self_device_time_total, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    if not rows:
        return {"device_time": "not measured"}
    total_us = sum(us for _, us, _ in rows)
    rows.sort(key=lambda r: -r[1])
    shares = {label: {"ms_per_call": sum(us for k, us, _ in rows if sub in k)
                      / 1e3 / iters,
                      "share": sum(us for k, us, _ in rows if sub in k)
                      / total_us,
                      "calls_per_call": sum(c for k, _, c in rows if sub in k)
                      / iters}
              for label, sub in (groups or {}).items()}
    return {"iters": iters, "groups": shares,
            "wall_ms_per_call": wall * 1e3 / iters,
            "device_ms_per_call": total_us / 1e3 / iters,
            "device_busy_share": total_us / 1e6 / wall,
            "kernels_per_call": sum(c for _, _, c in rows) / iters,
            "top": [{"name": k[:90], "ms_per_call": us / 1e3 / iters,
                     "share": us / total_us, "calls_per_call": c / iters}
                    for k, us, c in rows[:8]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every phase's record to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    record = {}

    smi = nvidia_smi()
    cap = torch.cuda.get_device_capability(device)
    env = {"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, "capability": list(cap),
           "device": torch.cuda.get_device_name(device),
           "device_count": torch.cuda.device_count()}
    emit(env)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0, got "
                         f"{cap}")
    record["env"] = env

    t0 = time.perf_counter()
    _build.library()
    build_log = (_build.build().parent / "build.log")
    build = {"phase": "build", "seconds": time.perf_counter() - t0,
             "library": str(_build.build().relative_to(
                 _build.PACKAGE_DIR.parent)),
             "ptxas": [ln.strip() for ln in build_log.read_text()
                       .splitlines()
                       if "Used" in ln or "==" in ln or "spill" in ln]
             if build_log.exists() else []}
    emit(build)
    record["build"] = build

    timer = Timer(device)
    cases, worst = phase_kernels(device, timer, args.seed)
    emit({"phase": "kernels", "cases": cases})
    record["kernels"] = cases

    parity = phase_parity(device, args.seed)
    emit({"phase": "parity", **parity})
    record["parity"] = parity
    if not parity["ok"]:
        raise AssertionError(f"parity failed: {parity}")

    serve, params, plens = phase_serve(device, args.seed)
    emit({"phase": "serve", **serve})
    record["serve"] = serve
    if not serve["ok"]:
        raise AssertionError(f"serve failed: {serve}")

    kernels, steps = main_path_timing(device, timer, params, plens, serve,
                                      args.seed, worst, serve["launches"])
    del params

    train_parity = phase_train_parity(device, args.seed)
    emit({"phase": "train_parity", **train_parity})
    record["train_parity"] = train_parity
    if not train_parity["ok"]:
        raise AssertionError(f"train parity failed: {train_parity}")

    train, params, batches = phase_train(device, args.seed)
    emit({"phase": "train", **train})
    record["train"] = train
    if not train["ok"]:
        raise AssertionError(f"train failed: {train}")

    bwd_rows, steps["train"] = train_timing(device, timer, params, batches,
                                            args.seed, worst,
                                            train["launches"])
    k1, k4 = kernels
    k1["launches_by_path"] = {"serve": k1["launches"],
                              "train": train["launches"]["flash_fwd"]}
    k1["launches"] = sum(k1["launches_by_path"].values())
    kernels = [k1, *bwd_rows, k4]
    emit({"phase": "main_path_steps", **steps})
    record["main_path_steps"] = steps
    record["kernels_summary"] = kernels
    smi_after = nvidia_smi()
    record["nvidia_smi"] = smi_after
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(smi_after, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
