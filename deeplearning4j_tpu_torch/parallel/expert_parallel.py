"""Expert (MoE) parallelism, the counterpart of the JAX package's
`parallel/expert_parallel.py`.

Experts live split over an `expert` mesh axis, tokens are gated top-1
(switch-style: the gate probability scales the expert output, so the
router gets a gradient), and each rank computes its local experts'
share. Two dispatches, as in the JAX package:

- `moe_apply`, dense/masked: every rank runs its experts over all of
  its tokens, masked down to the tokens routed to them, and one `psum`
  over the expert axis combines the shares. No token is dropped: the
  exact baseline.
- `moe_apply_a2a`, capacity-factor all-to-all: tokens split over the
  expert axis (and the data axis, when given), each rank packs its
  tokens into per-expert buffers of capacity ceil(cf * n_local / E),
  one `all_to_all` delivers them to the experts' owners, the local
  experts run, and a second `all_to_all` brings the outputs back. A
  token past its expert's capacity is DROPPED (output 0), written to a
  garbage slot at index `cap` so it never overwrites a kept token; with
  cf >= E nothing can drop and the result equals `moe_reference`.

The functions take and return GLOBAL arrays, every rank computing its
part (`shard_map`'s form in the JAX package), and every rank returns the
same output. A `data` axis composes: tokens split over it too (ep x dp).
`moe_grad_step` sums each gradient over the expert and data axes: a
rank's gradient is nonzero only on its experts, and the gate's on its
tokens.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.parallel import collectives as C

EXPERT_AXIS = "expert"

__all__ = ["EXPERT_AXIS", "init_moe_params", "moe_reference", "moe_apply",
           "moe_apply_a2a", "moe_grad_step"]


def init_moe_params(gen: torch.Generator, n_experts: int, d_in: int,
                    d_hidden: int, scale: float = 0.5, device=None):
    """Router + per-expert 2-layer MLP. W1: (E, d_in, d_hidden),
    W2: (E, d_hidden, d_in), drawn on the CPU from the torch generator
    `gen` and moved to `device` (None = the card, raising without one)."""
    device = default_device(device)
    def u(shape, d):
        return ((torch.rand(shape, generator=gen, dtype=torch.float32) * 2
                 - 1) * (scale / d)).to(device)

    return {
        "gate": u((d_in, n_experts), d_in),
        "W1": u((n_experts, d_in, d_hidden), d_in),
        "b1": torch.zeros((n_experts, 1, d_hidden), device=device),
        "W2": u((n_experts, d_hidden, d_in), d_hidden),
        "b2": torch.zeros((n_experts, 1, d_in), device=device),
    }


def _expert_ffn(w1, b1, w2, b2, x, act):
    return act(x @ w1 + b1) @ w2 + b2


def moe_reference(params, x, act: Callable = torch.tanh):
    """Unsharded ground truth: top-1 gate, run every expert densely,
    combine. x: (N, d_in)."""
    logits = x @ params["gate"]                      # (N, E)
    probs = torch.softmax(logits, dim=-1)
    choice = torch.argmax(logits, dim=-1)            # (N,)
    out = torch.zeros_like(x)
    for e in range(params["W1"].shape[0]):
        mask = (choice == e)[:, None]
        y = _expert_ffn(params["W1"][e], params["b1"][e],
                        params["W2"][e], params["b2"][e], x, act)
        out = out + torch.where(mask, probs[:, e:e + 1] * y, 0.0)
    return out


def _local_experts(params, mesh, axis):
    ep = int(mesh.shape[axis])
    n_experts = params["W1"].shape[0]
    if n_experts % ep:
        raise ValueError(f"{n_experts} experts not divisible by "
                         f"expert-axis size {ep}")
    return ep, n_experts, n_experts // ep


def _rows(x, mesh, axes):
    """This rank's rows of x split over `axes` (first axis major)."""
    k = mesh.axis_size(axes)
    n = x.shape[0] // k
    i = mesh.linear_index(axes)
    return x[i * n:(i + 1) * n]


def moe_apply(params, x, mesh, axis: str = EXPERT_AXIS,
              act: Callable = torch.tanh,
              data_axis: Optional[str] = None):
    """Expert-parallel forward: experts split over `axis`, tokens
    (optionally) over `data_axis`; one psum combines the local experts'
    shares. Matches moe_reference exactly."""
    _, _, local = _local_experts(params, mesh, axis)
    xb = _rows(x, mesh, data_axis) if data_axis else x
    # the gate is replicated, so routing is identical everywhere
    logits = xb @ params["gate"]
    probs = torch.softmax(logits, dim=-1)
    choice = torch.argmax(logits, dim=-1)
    first = mesh.axis_index(axis) * local
    out = torch.zeros_like(xb)
    for j in range(local):
        e = first + j
        y = _expert_ffn(params["W1"][e], params["b1"][e], params["W2"][e],
                        params["b2"][e], xb, act)
        # unrouted tokens are zeroed by the gate mask, so the psum of
        # the shares equals the dense reference
        gp = torch.where(choice == e, probs[:, e], 0.0)
        out = out + gp[:, None] * y
    out = C.psum(out, mesh, axis)
    if data_axis:
        out = C.all_gather(out, mesh, data_axis)
    return out


def moe_apply_a2a(params, x, mesh, axis: str = EXPERT_AXIS,
                  act: Callable = torch.tanh,
                  data_axis: Optional[str] = None,
                  capacity_factor: float = 1.0,
                  return_stats: bool = False):
    """Capacity-factor all-to-all dispatch, the bandwidth-optimal form:
    each token moves once to the rank owning its expert and once back.
    `return_stats` also returns the number of dropped tokens (a 0-d
    tensor, summed over all ranks)."""
    ep, n_experts, local = _local_experts(params, mesh, axis)
    shards = ep * (int(mesh.shape[data_axis]) if data_axis else 1)
    n_tokens = x.shape[0]
    if n_tokens % shards:
        raise ValueError(f"{n_tokens} tokens not divisible by "
                         f"{shards} token shards")
    n_loc = n_tokens // shards
    cap = max(1, int(-(-capacity_factor * n_loc // n_experts)))  # ceil
    token_axes = (data_axis, axis) if data_axis else (axis,)
    xb = _rows(x, mesh, token_axes)
    first = mesh.axis_index(axis) * local
    logits = xb @ params["gate"]                     # (n_loc, E)
    probs = torch.softmax(logits, dim=-1)
    choice = torch.argmax(logits, dim=-1)            # (n_loc,)
    prob = torch.gather(probs, 1, choice[:, None])[:, 0]
    # slot of each token in its expert's buffer = its rank among the
    # local tokens choosing that expert (first come, first served)
    onehot = (choice[:, None] == torch.arange(n_experts,
                                              device=x.device)[None, :])
    ranks = torch.cumsum(onehot.to(torch.int64), dim=0) - 1
    rank = torch.gather(ranks, 1, choice[:, None])[:, 0]
    keep = rank < cap
    # overflow tokens scatter into the cap-index garbage slot
    slot = torch.where(keep, rank, torch.full_like(rank, cap))
    buf = torch.zeros((n_experts, cap + 1, xb.shape[-1]), dtype=xb.dtype,
                      device=xb.device)
    buf = buf.index_put((choice, slot), xb)[:, :cap]  # (E, cap, d)
    # deliver: chunk e of dim 0 goes to expert e's owner; received row
    # (s * local + j) is what rank s packed for my local expert j
    recv = C.all_to_all(buf.contiguous(), mesh, axis)  # (ep*local, cap, d)
    recv = recv.reshape(ep, local, cap, -1)
    ys = []
    for j in range(local):
        t = recv[:, j].reshape(ep * cap, -1)         # all tokens for my j
        e = first + j
        yj = _expert_ffn(params["W1"][e], params["b1"][e], params["W2"][e],
                         params["b2"][e], t, act)
        ys.append(yj.reshape(ep, cap, -1))
    out_buf = torch.stack(ys, dim=1).reshape(ep * local, cap, -1)
    # return trip: back[e, c] = my token that sat in slot c of the
    # buffer I sent toward expert e
    back = C.all_to_all(out_buf.contiguous(), mesh, axis)
    gathered = back[choice, torch.clamp(slot, 0, cap - 1)]
    out = torch.where(keep[:, None], prob[:, None] * gathered, 0.0)
    out = C.all_gather(out, mesh, token_axes)
    if not return_stats:
        return out
    dropped = torch.logical_not(keep).sum().reshape(1)
    all_axes = (axis, data_axis) if data_axis else axis
    return out, C.all_reduce_(dropped, mesh, all_axes)[0]


def moe_grad_step(params, x, y, mesh, axis: str = EXPERT_AXIS,
                  lr: float = 0.1, act: Callable = torch.tanh,
                  data_axis: Optional[str] = None,
                  dispatch: str = "dense",
                  capacity_factor: float = 1.0):
    """One SGD step on MSE through the expert-parallel block; returns
    (params, loss), the same on every rank. dispatch: 'dense' (masked
    psum combine) or 'a2a' (capacity-factor all-to-all)."""
    if dispatch not in ("dense", "a2a"):
        raise ValueError(f"unknown dispatch {dispatch!r}; "
                         "expected 'dense' or 'a2a'")
    names = sorted(params)
    p = {k: params[k].detach().clone().requires_grad_(True) for k in names}
    with torch.enable_grad():
        if dispatch == "a2a":
            out = moe_apply_a2a(p, x, mesh, axis, act, data_axis,
                                capacity_factor=capacity_factor)
        else:
            out = moe_apply(p, x, mesh, axis, act, data_axis)
        loss = torch.mean((out - y) ** 2)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
    axes = (axis, data_axis) if data_axis else axis
    with torch.no_grad():
        new = {}
        for k, g in zip(names, grads):
            g = C.all_reduce_(g.contiguous(), mesh, axes)
            new[k] = params[k] - lr * g
    return new, loss.detach()
