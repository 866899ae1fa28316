"""The plain reference of the GPT-2 family as the port lays it out: plain
torch in float32, with TF32 off, no kernels, no cache and no batching
across requests.

A pre-LN block: x + Attn(LN1(x)), then x + W2 gelu_tanh(LN2(x) W1 + b1)
+ b2; learned positions; a final layer norm (eps 1e-5, population
variance); an output head tied to the embedding; causal softmax
attention at scale 1/sqrt(head dim). Departure from GPT-2, as the port
has it: no biases on the Q, K, V and O projections.

`precision="fp8"` is the control: every matrix product (the
projections, the feed-forward, both attention products and the head)
takes its operands rounded to float8 e4m3 with one scale a tensor: the
step below the bfloat16 that the configuration states.

Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.fp8 import matmul, strict_float32  # noqa: F401


def layer_norm(p, x, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def block(p, x, n_heads: int, precision: str):
    b, t, d = x.shape
    hd = d // n_heads
    h = layer_norm(p["ln1"], x)

    def heads(w):
        return matmul(h, w, precision).reshape(b, t, n_heads, hd) \
            .transpose(1, 2)

    q, k, v = heads(p["Wq"]), heads(p["Wk"]), heads(p["Wv"])
    s = matmul(q, k.transpose(-1, -2), precision) / math.sqrt(hd)
    mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    a = matmul(torch.softmax(s, dim=-1), v, precision)
    a = a.transpose(1, 2).reshape(b, t, d)
    x = x + matmul(a, p["Wo"], precision)
    h = layer_norm(p["ln2"], x)
    u = F.gelu(matmul(h, p["W1"], precision) + p["b1"], approximate="tanh")
    return x + matmul(u, p["W2"], precision) + p["b2"]


def hidden(params, tokens, n_heads: int, precision: str = "float32"):
    """(B, T) tokens -> (B, T, d) final-layer-normed states."""
    t = tokens.shape[1]
    x = params["embed"][tokens.long()] + params["pos"][:t]
    for p in params["blocks"]:
        x = block(p, x, n_heads, precision)
    return layer_norm(params["ln_f"], x)


def logits(params, tokens, n_heads: int, precision: str = "float32"):
    """(B, T) tokens -> (B, T, vocab) logits."""
    h = hidden(params, tokens, n_heads, precision)
    return matmul(h, params["embed"].T, precision)


@torch.no_grad()
def served_gaps(params, n_heads: int, prompt, served,
                precision: str = "float32", ref_logits=None):
    """For each served token of one request, how far the float32
    reference's logit of that token lies below its best logit at that
    position (0 where the served token is the reference's first choice).

    With `precision="fp8"` the tokens judged are the ones the control
    puts first at each of those positions, the gaps still read in the
    float32 reference (`ref_logits`, from a float32 call, is reused when
    given). Returns (gaps, float32 logits at the served positions)."""
    device = params["embed"].device
    seq = torch.tensor(list(prompt) + list(served)[:-1], device=device)[None]
    start = len(prompt) - 1
    n = len(served)
    if ref_logits is None:
        ref_logits = logits(params, seq, n_heads)[0, start:start + n]
    if precision == "float32":
        chosen = torch.tensor(list(served), device=device)
    else:
        low = logits(params, seq, n_heads, precision)[0, start:start + n]
        chosen = low.argmax(dim=-1)
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, chosen[:, None].long())[:, 0]
    return (best - got).cpu(), ref_logits
