"""Seeded weights made on the device in a few large calls.

`gpt2_params(cfg, seed, device, dtype)` lays out the port's transformer
parameter dict (`embed`, `pos`, `ln_f`, `blocks[i]` with `ln1`, `Wq`,
`Wk`, `Wv`, `Wo`, `ln2`, `W1`, `b1`, `W2`, `b2`) as views into one
buffer drawn by a single `torch.randn` on a `torch.Generator` of the
device, then scaled by GPT-2's initialisation: normal at 0.02, the two
projections into the residual stream (`Wo`, `W2`) at 0.02 /
sqrt(2 n_layers); layer-norm gains 1 + GAIN_SD N(0, 1), the layer
norms' biases and b1 BIAS_SD N(0, 1), and b2, which adds to the
residual stream in every block, at the residual projections' scale (at
BIAS_SD the 24 of them would swamp the stream and every position would
serve the same few tokens), so that a gain or a bias the program drops
or misapplies moves its logits. The same seed on the
same device gives the same tensors, so the reference regenerates them
instead of reading the program's.

`mlp_params(sizes, seed, device)` draws BASELINE config 1's weights the
port's way (uniform in +-sqrt(6 / (fan_in + fan_out)), biases zero) in
one `torch.rand`, laid out as the port's network table
`{"0": {"W", "b"}, ...}` with `b` of shape (1, n_out).
"""

from __future__ import annotations

import math

import torch

#: spread of the layer norms' gains about 1, and of their biases and
#: b1 about 0
GAIN_SD = 0.1
BIAS_SD = 0.1


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def gpt2_params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    d, f, L = cfg["d_model"], cfg["d_ff"], cfg["n_layers"]
    V, T = cfg["vocab_size"], cfg["max_len"]
    n_ln = 2 * L + 1
    shapes = [("embed", (V, d)), ("pos", (T, d))]
    for i in range(L):
        shapes += [((i, "Wq"), (d, d)), ((i, "Wk"), (d, d)),
                   ((i, "Wv"), (d, d)), ((i, "Wo"), (d, d)),
                   ((i, "W1"), (d, f)), ((i, "W2"), (f, d))]
    # the layer norms' gains and biases, then the feed-forward biases
    shapes += [("gains", (n_ln, d)), ("ln_b", (n_ln, d)), ("b1", (L, f)),
               ("b2", (L, d))]
    total = sum(math.prod(s) for _, s in shapes)
    flat = torch.randn(total, generator=_generator(seed, device),
                       device=device, dtype=dtype)
    resid = 0.02 / math.sqrt(2 * L)
    scale = {"Wo": resid, "W2": resid, "b2": resid, "gains": GAIN_SD,
             "ln_b": BIAS_SD, "b1": BIAS_SD}
    views, off = {}, 0
    for key, shape in shapes:
        n = math.prod(shape)
        v = flat[off:off + n].view(shape)
        name = key[1] if isinstance(key, tuple) else key
        v.mul_(scale.get(name, 0.02))
        views[key] = v
        off += n
    gains = views["gains"].add_(1.0)
    ln_b = views["ln_b"]

    def ln(j):
        return {"g": gains[j], "b": ln_b[j]}

    params = {"embed": views["embed"], "pos": views["pos"],
              "ln_f": ln(2 * L), "blocks": []}
    for i in range(L):
        params["blocks"].append({
            "ln1": ln(2 * i), "Wq": views[(i, "Wq")],
            "Wk": views[(i, "Wk")], "Wv": views[(i, "Wv")],
            "Wo": views[(i, "Wo")], "ln2": ln(2 * i + 1),
            "W1": views[(i, "W1")], "b1": views["b1"][i],
            "W2": views[(i, "W2")], "b2": views["b2"][i]})
    return params


def mlp_params(sizes, seed: int, device) -> dict:
    shapes = list(zip(sizes[:-1], sizes[1:]))
    total = sum(a * b for a, b in shapes)
    flat = torch.rand(total, generator=_generator(seed, device),
                      device=device, dtype=torch.float32)
    table, off = {}, 0
    for i, (a, b) in enumerate(shapes):
        r = math.sqrt(6.0 / (a + b))
        w = flat[off:off + a * b].view(a, b).mul_(2 * r).sub_(r)
        table[str(i)] = {"W": w, "b": torch.zeros((1, b), device=device)}
        off += a * b
    return table


def leaves(tree) -> list:
    """(path, tensor) of every leaf, in a fixed order."""
    out = []

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in node:
                walk(f"{prefix}{k}/", node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}/", v)
        else:
            out.append((prefix[:-1], node))

    walk("", tree)
    return out


def to_float32(tree):
    """A float32 copy of every leaf (the reference's own tensors)."""
    if isinstance(tree, dict):
        return {k: to_float32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_float32(v) for v in tree]
    return tree.detach().float().clone()
