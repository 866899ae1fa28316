"""Pipeline (stage) parallelism, the counterpart of the JAX package's
`parallel/pipeline.py`.

GPipe-style microbatch pipelining: stage i lives on the rank of index i
of a `pipe` mesh axis, activations travel to the next stage with
`collectives.ppermute`, and the schedule is S + M - 1 ticks (S stages,
M microbatches): at tick t stage 0 takes microbatch t while they last,
every other stage takes what the previous tick delivered, and the last
stage finishes microbatch t - (S - 1). The bubble is the (S - 1)-tick
fill and drain the schedule implies. Autograd runs straight through the
schedule (a ppermute's backward is the reverse ppermute), so one
backward trains the whole pipeline; a `data` axis composed into the mesh
splits each microbatch's rows (pp x dp).

As in the JAX package's `shard_map` form the functions take and return
GLOBAL arrays, every rank computing its own part: its stage's slice of
the stacked parameters, its rows of the microbatches. The last stage's
outputs are psummed to every stage (and gathered over the data axis),
so every rank returns the same (M, B, d) and computes the same loss.
The stage index is a plain int, so JAX's masked `where`s become `if`s;
a tick's received activation a stage does not use, and a stage's last
activation, are still joined to its output (`collectives.depend`), so
every rank runs every backward exchange. The last tick's activations go
nowhere and are not sent.

Scope: uniform stages (each stage one dense block of identical shape,
parameters stacked on a leading stage axis), as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from deeplearning4j_tpu_torch.parallel import collectives as C

PIPE_AXIS = "pipe"

__all__ = ["PIPE_AXIS", "init_pipeline_params", "sequential_apply",
           "pipeline_apply", "pipeline_grad_step"]


def init_pipeline_params(gen: torch.Generator, n_stages: int, width: int,
                         scale=0.5, device="cpu"):
    """Uniform stack: W (S, d, d) uniform in +-scale/d, b (S, 1, d)
    zeros, drawn from the torch generator `gen`."""
    w = (torch.rand((n_stages, width, width), generator=gen,
                    dtype=torch.float32) * 2 - 1) * (scale / width)
    return {"W": w.to(device),
            "b": torch.zeros((n_stages, 1, width), dtype=torch.float32,
                             device=device)}


def sequential_apply(params, x, act: Callable = torch.tanh):
    """Ground truth: apply the S stacked stages one after another.
    x: (..., width)."""
    for i in range(params["W"].shape[0]):
        x = act(x @ params["W"][i] + params["b"][i])
    return x


def pipeline_apply(params, xm, mesh, axis: str = PIPE_AXIS,
                   act: Callable = torch.tanh,
                   data_axis: Optional[str] = None):
    """Run microbatches through the stage pipeline.

    params: {"W": (S, d, d), "b": (S, 1, d)}, the whole stack on every
    rank (each uses its stage's slice); xm: (M, B, d) microbatches (B
    split over `data_axis` if given). Returns (M, B, d) pipeline outputs
    == sequential_apply per microbatch, on every rank."""
    s = int(mesh.shape[axis])
    if params["W"].shape[0] != s:
        raise ValueError(f"{params['W'].shape[0]} stages vs pipe={s}")
    m = xm.shape[0]
    idx = mesh.axis_index(axis)
    perm = [(i, (i + 1) % s) for i in range(s)]
    w, b = params["W"][idx], params["b"][idx]
    xs = xm
    if data_axis:
        k = mesh.axis_size(data_axis)
        rows = xm.shape[1] // k
        j = mesh.axis_index(data_axis)
        xs = xm[:, j * rows:(j + 1) * rows]
    buf = torch.zeros_like(xs[0])  # activation arriving from the left
    outs = [None] * m              # the last stage's finished outputs
    unused = []
    for t in range(s + m - 1):
        # stage 0 ingests microbatch t while they last; later stages
        # consume what the previous tick's ppermute delivered
        if idx == 0 and t < m:
            inp = xs[t]
            unused.append(buf)
        else:
            inp = buf
        out = act(inp @ w + b)
        mb = t - (s - 1)  # the LAST stage finishes microbatch t-(S-1)
        if idx == s - 1 and mb >= 0:
            outs[mb] = out
        if t < s + m - 2:
            buf = C.ppermute(out, mesh, axis, perm)
    if idx != s - 1:
        # the last tick's activation reaches nothing here; joined, it
        # carries this stage's chain of receives into the backward
        unused.append(out)
    if idx == s - 1:
        result = torch.stack(outs)
    else:
        result = torch.zeros_like(xs)
    # outputs exist only on the last stage: the psum hands them to all
    result = C.psum(result, mesh, axis)
    if data_axis:
        result = C.all_gather(result, mesh, data_axis, dim=1)
    return C.depend(result, *[u for u in unused if u.requires_grad])


def pipeline_grad_step(params, xm, ym, mesh, axis: str = PIPE_AXIS,
                       lr: float = 0.1, act: Callable = torch.tanh,
                       data_axis: Optional[str] = None):
    """One SGD step through the pipeline (mean-squared error over all
    microbatches); returns (params, loss), both the same on every rank.
    The gradient flows backward through the tick schedule; each rank's
    gradient is nonzero on its stage only (and its rows), so one
    all-reduce over the pipe and data axes assembles the whole one."""
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    with torch.enable_grad():
        out = pipeline_apply(p, xm, mesh, axis, act, data_axis)
        loss = torch.mean((out - ym) ** 2)
        grads = torch.autograd.grad(loss, [p["W"], p["b"]])
    axes = (axis, data_axis) if data_axis else axis
    with torch.no_grad():
        new = {}
        for name, g in zip(("W", "b"), grads):
            g = C.all_reduce_(g.contiguous(), mesh, axes)
            new[name] = params[name] - lr * g
    return new, loss.detach()
