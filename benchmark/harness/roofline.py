"""The yardstick's arithmetic: the peaks of one NVIDIA H100, the bytes and
operations the paged decode kernel (K4) must move and do, and the model
FLOPs of a served transformer's tokens and of an MLP training step.

`paged_work` and `bound_s` are copies of `chip_smoke.py`'s `paged_work`
and `bound_ms`, kept here so that no change to the program can change
what a kernel's roofline share is measured against. Itemsizes are given
as numbers, so this file needs no torch.
"""

from __future__ import annotations

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def paged_work(lengths, heads, hd, ps, width, dtype="bfloat16"):
    """(bytes, operations) of one paged decode call (K4): the written
    pages of K and V read once (the pages these cursors reach), q read
    and out written once, plus the table row and cursor; 4*hd operations
    per visible position. `lengths` holds each row's cursor, the index
    of the position its query sits at. Every term is a sum over rows, so
    the work of many calls is the work of their rows taken together."""
    itemsize = ITEMSIZE[dtype]
    pages = sum(min(int(p) // ps + 1, width) for p in lengths)
    nbytes = (2 * pages * heads * ps * hd * itemsize
              + 2 * len(lengths) * heads * hd * itemsize
              + len(lengths) * (width + 1) * 4)
    positions = sum(min(int(p) + 1, width * ps) for p in lengths)
    return nbytes, 4 * hd * heads * positions


def bound_s(nbytes, ops, dtype="bfloat16"):
    """(least seconds the chip could take, "bytes" or "operations")."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ------------------------------------------------------------ model FLOPs
def block_matmul_params(d: int, d_ff: int) -> int:
    """Weights one transformer block multiplies a token by: Q, K, V, O
    (4 d^2) and the two feed-forward matrices (2 d d_ff)."""
    return 4 * d * d + 2 * d * d_ff


def causal_pairs(t: int) -> int:
    """Visible (query, key) pairs of a causal sequence of t tokens."""
    return t * (t + 1) // 2


def lm_forward_flops(cfg: dict, prompt_tokens: int = 0,
                     prompt_pairs: int = 0, head_rows: int = 0,
                     decode_contexts=()) -> float:
    """Model FLOPs of a serving run's forward work: 2 per weight a token
    meets in the blocks, 2 d V for each row the output head scores, and
    4 hd per visible (query, key) pair per head and layer. `prompt_pairs`
    sums the causal pairs of the prompts; each decode context is the
    number of positions that token's query sees (it also pays the
    head)."""
    d, L = cfg["d_model"], cfg["n_layers"]
    heads, hd = cfg["n_heads"], cfg["d_model"] // cfg["n_heads"]
    per_tok = 2 * L * block_matmul_params(d, cfg["d_ff"])
    head = 2 * d * cfg["vocab_size"]
    attn = 4 * hd * heads * L
    n_dec = len(decode_contexts)
    return (per_tok * (prompt_tokens + n_dec)
            + head * (head_rows + n_dec)
            + attn * (prompt_pairs + sum(decode_contexts)))


def mlp_train_step_flops(sizes, rows: int) -> float:
    """Model FLOPs of one MLP training step over `rows` examples: 6 per
    weight and example (forward product, and two in the backward)."""
    weights = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    return 6.0 * weights * rows
