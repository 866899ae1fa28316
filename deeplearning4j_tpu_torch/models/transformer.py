"""Causal transformer language model in PyTorch — the counterpart of the
JAX package's `models/transformer.py`: forward, greedy generation, and
training (`lm_loss`, `make_train_step`, `init_velocity`, `fit_scan`, SGD
with momentum) whose attention gradients run through the flash backward
kernels (K2, K3) by way of `attention/flash.py`'s autograd Function.

Parameters are a plain dict with the JAX pytree's keys — `embed`, `pos`,
`ln_f`, and `blocks[i]` holding `ln1`, `Wq`, `Wk`, `Wv`, `Wo`, `ln2`,
`W1`, `b1`, `W2`, `b2` — so weights carry across with
`weights.params_from_jax`. Pre-LN residual blocks, attention through the
flash forward kernel over (B, H, T, hd), GELU in its tanh form (JAX's
default), and an output head tied to the embedding.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.attention.flash import flash_attention
from deeplearning4j_tpu_torch.weights import tree_map


class TransformerConfig(NamedTuple):
    vocab_size: int
    d_model: int = 128
    n_heads: int = 2
    n_layers: int = 2
    d_ff: int = 512
    max_len: int = 256
    dtype: torch.dtype = torch.float32


def init_transformer_params(seed: int, cfg: TransformerConfig,
                            device=None) -> Dict[str, Any]:
    """Embedding (tied with the output head), learned positions, and
    per-block {ln1, attn(Wq/Wk/Wv/Wo), ln2, ffn(W1/b1/W2/b2)}: normal
    weights at scale 0.02 drawn from a CPU `torch.Generator` seeded with
    `seed` (the same numbers on every device; not the JAX package's
    numbers — carry weights across with `weights.params_from_jax`)."""
    device = default_device(device)
    d, f = cfg.d_model, cfg.d_ff
    if d % cfg.n_heads:
        raise ValueError(f"d_model {d} not divisible by n_heads "
                         f"{cfg.n_heads}")
    gen = torch.Generator().manual_seed(int(seed))

    def normal(*shape):
        w = 0.02 * torch.randn(*shape, generator=gen, dtype=torch.float32)
        return w.to(device=device, dtype=cfg.dtype)

    def ln():
        return {"g": torch.ones(d, dtype=cfg.dtype, device=device),
                "b": torch.zeros(d, dtype=cfg.dtype, device=device)}

    params: Dict[str, Any] = {"embed": normal(cfg.vocab_size, d),
                              "pos": normal(cfg.max_len, d),
                              "ln_f": ln(), "blocks": []}
    for _ in range(cfg.n_layers):
        params["blocks"].append({
            "ln1": ln(),
            "Wq": normal(d, d), "Wk": normal(d, d),
            "Wv": normal(d, d), "Wo": normal(d, d),
            "ln2": ln(),
            "W1": normal(d, f),
            "b1": torch.zeros(f, dtype=cfg.dtype, device=device),
            "W2": normal(f, d),
            "b2": torch.zeros(d, dtype=cfg.dtype, device=device),
        })
    return params


def _layer_norm(p, x, eps=1e-5):
    # statistics in float32 with the population variance, cast back to
    # x's dtype BEFORE the affine, as the JAX reference does
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * p["g"] + p["b"]


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def _block(p, x, cfg: TransformerConfig):
    b, t, d = x.shape
    hd = d // cfg.n_heads
    h = _layer_norm(p["ln1"], x)

    def heads(w):
        return (h @ w).reshape(b, t, cfg.n_heads, hd).transpose(1, 2)

    att = flash_attention(heads(p["Wq"]), heads(p["Wk"]), heads(p["Wv"]),
                          True)
    att = att.transpose(1, 2).reshape(b, t, d)
    x = x + att @ p["Wo"]
    h = _layer_norm(p["ln2"], x)
    return x + _gelu(h @ p["W1"] + p["b1"]) @ p["W2"] + p["b2"]


def transformer_logits(params, tokens, cfg: TransformerConfig):
    """tokens: (B, T) int -> (B, T, vocab) logits. Output head tied to
    the embedding."""
    b, t = tokens.shape
    if t > cfg.max_len:
        raise ValueError(f"sequence {t} exceeds max_len {cfg.max_len}")
    x = params["embed"][tokens.long()] + params["pos"][:t]
    for p in params["blocks"]:
        x = _block(p, x, cfg)
    x = _layer_norm(params["ln_f"], x)
    return x @ params["embed"].T


def lm_loss(params, tokens, cfg: TransformerConfig):
    """Next-token cross entropy, mean over the (B, T-1) positions of
    tokens[:, :-1] -> tokens[:, 1:]; logits upcast to float32 before the
    log-softmax. A 0-d float32 tensor on the params' device."""
    tokens = tokens.to(params["embed"].device)
    logits = transformer_logits(params, tokens[:, :-1], cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    targets = tokens[:, 1:].long()
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def lm_loss_and_grads(params, tokens, cfg: TransformerConfig):
    """(lm_loss, its gradient as a tree shaped like params): the port's
    `jax.value_and_grad(lm_loss)`. The gradient is taken at detached
    aliases of the leaves, so params never require grad and no graph
    outlives the call."""
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    it = iter(leaves)
    tracked = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss = lm_loss(tracked, tokens, cfg)
        grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(grads), params)


@torch.no_grad()
def _sgd_momentum_update(params, velocity, grads, lr, momentum=0.9):
    """The one update rule both training entry points share, in place:
    v = momentum * v + g in float32, then p = p - lr * v.to(p.dtype).
    The cast comes before the product, and lr is rounded to p's dtype,
    so a bfloat16 parameter rounds where JAX's does."""
    for p, v, g in zip(_leaves(params), _leaves(velocity), _leaves(grads)):
        v.mul_(momentum).add_(g)
        lr_p = torch.tensor(lr, dtype=p.dtype).item()
        p.sub_(v.to(p.dtype) * lr_p)


def init_velocity(params):
    """Float32 zeros shaped like every leaf of params."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def make_train_step(cfg: TransformerConfig, lr: float = 1e-2):
    """step(params, velocity, tokens) -> (params, velocity, loss): one
    SGD + momentum step on the LM loss. The forward launches K1 with its
    lse and the backward K2 and K3 in every block. params and velocity
    are updated in place (the port's form of JAX's donation) and handed
    back; the loss stays a 0-d device tensor, so a step makes no host
    sync."""

    def step(params, velocity, tokens):
        loss, grads = lm_loss_and_grads(params, tokens, cfg)
        _sgd_momentum_update(params, velocity, grads, lr)
        return params, velocity, loss

    return step


def fit_scan(params, tokens_batches, cfg: TransformerConfig,
             lr: float = 1e-2, epochs: int = 1):
    """Whole-epoch training: `epochs` passes over tokens_batches
    (n_batches, B, T), one train step a batch, from a zero velocity.
    Updates params in place and returns (params, last loss), the loss a
    0-d device tensor; nothing reads a value back between steps."""
    batches = torch.as_tensor(tokens_batches).to(params["embed"].device)
    if int(epochs) < 1 or batches.shape[0] < 1:
        raise ValueError(f"fit_scan needs epochs >= 1 and at least one "
                         f"batch, got {epochs} and {batches.shape[0]}")
    step = make_train_step(cfg, lr)
    velocity = init_velocity(params)
    for _ in range(int(epochs)):
        for batch in batches:
            params, velocity, loss = step(params, velocity, batch)
    return params, loss


@torch.no_grad()
def generate(params, prompt, cfg: TransformerConfig, n_tokens: int,
             cache: bool = False):
    """Greedy decoding: prompt (B, T0) -> (B, T0 + n_tokens).

    `cache=True` routes through the preallocated KV cache
    (serving/kv_cache.py): prefill once, then O(1) decode steps.
    `cache=False` keeps the full-recompute form: every step re-runs the
    whole prefix (causal masking makes the positions past the frontier
    irrelevant, so the prefix alone is run)."""
    b, t0 = prompt.shape
    if t0 + n_tokens > cfg.max_len:
        raise ValueError("generation would exceed max_len")
    prompt = prompt.to(device=params["embed"].device, dtype=torch.int32)
    if cache:
        if n_tokens < 1:
            raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
        # deferred import: serving builds on this module
        from deeplearning4j_tpu_torch.serving.kv_cache import generate_cached
        return generate_cached(params, prompt, cfg, int(n_tokens))
    buf = prompt
    for _ in range(n_tokens):
        logits = transformer_logits(params, buf, cfg)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        buf = torch.cat([buf, nxt[:, None]], dim=1)
    return buf


__all__ = ["TransformerConfig", "init_transformer_params",
           "transformer_logits", "lm_loss", "lm_loss_and_grads",
           "make_train_step", "init_velocity", "fit_scan", "generate"]
