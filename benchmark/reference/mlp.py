"""The plain reference of BASELINE config 1 trained under config 5:
784-2048-1024-10, ReLU, a softmax output with multi-class cross
entropy (probabilities clipped to [1e-7, 1 - 1e-7], the mean over the
rows), and the DL4J AdaGrad step of GradientAdjustment.java: hist +=
g^2; u = lr g / (sqrt(hist) + 1e-6); v = momentum v + u; p -= v / B,
with B the global batch's rows. Plain torch, float32 with TF32 off; the
global batch is one batch, with no ranks and no exchange. Nothing here
imports the program.

`keep_rows` and `grad_scale` plant the checks' faults in the reference
put in the program's place: half of the batch left out with the mean
over the rest, and one rank's rows alone at its share of the global
mean (the exchange between chips left out).
"""

from __future__ import annotations

import torch

from reference.fp8 import matmul

EPS = 1e-7
ADAGRAD_EPS = 1e-6


def loss(params, x, y, precision: str = "float32"):
    h = x
    n = len(params)
    for i in range(n):
        p = params[str(i)]
        z = matmul(h, p["W"], precision) + p["b"]
        h = torch.relu(z) if i < n - 1 else torch.softmax(z, dim=-1)
    out = torch.clamp(h, EPS, 1.0 - EPS)
    return -(y * torch.log(out)).sum() / x.shape[0]


def loss_and_grads(params, x, y, precision="float32", keep_rows=None,
                   grad_scale: float = 1.0):
    names = [(k, n) for k in params for n in params[k]]
    leaves = [params[k][n].detach().requires_grad_() for k, n in names]
    tree = {}
    for (k, n), t in zip(names, leaves):
        tree.setdefault(k, {})[n] = t
    if keep_rows is not None:
        x, y = x[keep_rows], y[keep_rows]
    with torch.enable_grad():
        value = loss(tree, x, y, precision)
        grads = torch.autograd.grad(value, leaves)
    return float(value.detach()) * grad_scale, [g * grad_scale for g in grads]


class AdaGrad:
    """The configuration's updater over a list of leaves."""

    def __init__(self, leaves, lr: float, momentum: float):
        self.lr, self.momentum = lr, momentum
        self.hist = [torch.zeros_like(p) for p in leaves]
        self.vel = [torch.zeros_like(p) for p in leaves]

    @torch.no_grad()
    def step(self, leaves, grads, batch: int) -> None:
        for p, g, h, v in zip(leaves, grads, self.hist, self.vel):
            h.add_(g * g)
            v.mul_(self.momentum).add_(self.lr * g / (h.sqrt() + ADAGRAD_EPS))
            p.sub_(v / batch)
