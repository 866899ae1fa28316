"""Ring attention: sequence-parallel attention over a mesh axis, the
counterpart of the JAX package's `attention/ring.py`.

Each rank holds one sequence shard of Q, K and V. The K/V shards rotate
around the ring with `collectives.ppermute` (one `batch_isend_irecv` a
step, nearest neighbours), and every rank keeps the online-softmax state
of ITS queries and folds in each visiting K/V shard. After n steps every
query has attended to every key; there are n - 1 rotations, the last
visiting shard is consumed without being sent on. Causal masking uses
global offsets from the rank's ring position.

`ring_attention` takes and returns THIS rank's shard: (..., T_local, d)
on each rank, rank i holding positions [i * T_local, (i + 1) * T_local)
of the global sequence, so each rank's memory stays at one shard however
long the sequence. The JAX function takes the global arrays; the parity
tests slice them.

Local engines (`local=`):

- "einsum": the plain float32 ring, explicit online softmax;
- "flash": the port's `flash_attention_with_lse` on each visiting shard
  (K1 with its lse forward, K2 and K3 backward through the joint
  (out, lse) Function, whose lse cotangent shifts K2/K3's D term); the
  per-shard results merge in log space:
      m' = max(m, lse_i); acc' = acc*e^(m-m') + out_i*e^(lse_i-m');
      s' = s*e^(m-m') + e^(lse_i-m');   out = acc / s.
  A shard in the causal past runs the mask-free kernel, the diagonal
  shard the causal one, and a future shard launches nothing and gives
  the merge identity (out 0, lse -inf). So a causal ring over n ranks
  launches K1 (and in its backward K2 and K3) n(n+1)/2 times over all
  ranks, a non-causal one n^2 times. As everywhere in the port, CPU
  tensors take K1's plain version and CUDA tensors launch the kernel or
  raise.

Sentinels. The merge identity is NEG_INF (-1e30). Both sides of a merge
are guarded (alpha, beta -> 0 at the sentinel), so a fully masked shard
folded while the carry is still at its init adds nothing whatever the
fold order; and K1's lse for a row that sees no key is +1e30 (its own
sentinel), which is mapped to NEG_INF before merging.
"""

from __future__ import annotations

import weakref
from typing import Optional

import torch

from deeplearning4j_tpu_torch.attention.blockwise import NEG_INF
from deeplearning4j_tpu_torch.parallel import collectives as C

__all__ = ["ring_attention", "merge_shard"]

#: mesh -> the (axis, batch_axis, shape) keys whose shards were checked
_CHECKED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _ring_perm(n: int):
    return [(i, (i + 1) % n) for i in range(n)]


def merge_shard(acc, m, s, out_i, lse_i):
    """Fold one shard's (out_i, lse_i) into the running (acc, m, s), all
    float32, with both sentinel guards; K1's +1e30 lse (a row that saw no
    key) counts as the -inf identity."""
    lse_i = torch.where(lse_i >= -NEG_INF / 2,
                        torch.full_like(lse_i, NEG_INF), lse_i)
    m_new = torch.maximum(m, lse_i)
    zero = torch.zeros_like(m_new)
    alpha = torch.where(m <= NEG_INF / 2, zero, torch.exp(m - m_new))
    beta = torch.where(lse_i <= NEG_INF / 2, zero, torch.exp(lse_i - m_new))
    return (acc * alpha[..., None] + out_i * beta[..., None], m_new,
            s * alpha + beta)


def _einsum_accumulate(acc, m, s, q32, k_cur, v_cur, q_pos, k_pos, causal,
                       scale):
    scores = torch.einsum("...qd,...kd->...qk", q32, k_cur.float()) * scale
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # a row that has seen only masked keys keeps m == m_new == NEG_INF,
    # where the unguarded exp()s would read 1
    alpha = torch.where(m <= NEG_INF / 2, torch.zeros_like(m_new),
                        torch.exp(m - m_new))
    p = torch.exp(scores - m_new[..., None])
    if causal:
        p = p * mask.float()
    s_new = s * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "...qk,...kd->...qd", p, v_cur.float())
    return acc_new, m_new, s_new


def _check_shards(q, mesh, axis: str, batch_axis: Optional[str]) -> int:
    """The JAX package's divisibility errors, on the global lengths the
    ranks' shards add up to: unequal shards are a global length the axis
    does not divide. Exchanged once per shape and mesh."""
    n = mesh.shape[axis]
    key = (axis, batch_axis, tuple(q.shape))
    checked = _CHECKED.setdefault(mesh, set())
    if key in checked:
        return n
    mine = torch.tensor([q.shape[-2], q.shape[0]], dtype=torch.int64,
                        device=mesh.device)
    lens = [int(g[0, 0]) for g in C._gather_chunks(mine[None], mesh, axis)]
    if len(set(lens)) != 1:
        raise ValueError(f"sequence length {sum(lens)} not divisible by "
                         f"mesh axis {axis!r} size {n}")
    if batch_axis is not None:
        rows = [int(g[0, 1])
                for g in C._gather_chunks(mine[None], mesh, batch_axis)]
        if len(set(rows)) != 1:
            raise ValueError(
                f"batch {sum(rows)} not divisible by mesh axis "
                f"{batch_axis!r} size {mesh.shape[batch_axis]}")
    checked.add(key)
    return n


def ring_attention(q, k, v, mesh, axis: str = "sp", causal: bool = False,
                   batch_axis: Optional[str] = None, local: str = "einsum"):
    """Full attention with Q/K/V sequence-sharded over `axis`.

    q, k, v: this rank's shard, (..., T_local, d), rank i of the axis
    holding the i-th block of the global sequence. Returns this rank's
    (..., T_local, d) of the output, in q's dtype, differentiable in q,
    k and v. `batch_axis` names a second mesh axis the batch (dim 0) is
    split over: each of its groups runs its own ring (dp x sp).

    `local` picks the per-step engine: "einsum" (float32 einsums and an
    explicit online softmax) or "flash" (the flash kernel per visiting
    shard, merged through its lse)."""
    if local not in ("einsum", "flash"):
        raise ValueError(f"unknown local engine {local!r}; "
                         "expected 'einsum' or 'flash'")
    n = _check_shards(q, mesh, axis, batch_axis)
    my = mesh.axis_index(axis)
    t_local = q.shape[-2]
    orig_dtype = q.dtype
    perm = _ring_perm(n)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32,
                   device=q.device)
    s = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    unused = []
    if local == "einsum":
        q32 = q.float()
        scale = 1.0 / float(q.shape[-1]) ** 0.5
        q_pos = my * t_local + torch.arange(t_local, device=q.device)
    else:
        from deeplearning4j_tpu_torch.attention.flash import (
            flash_attention_with_lse)
    for step in range(n):
        src = (my - step) % n  # whose shard this rank holds this step
        if local == "einsum":
            k_pos = src * t_local + torch.arange(t_local, device=q.device)
            acc, m, s = _einsum_accumulate(acc, m, s, q32, k_cur, v_cur,
                                           q_pos, k_pos, causal, scale)
        elif causal and src > my:
            # a future shard: fully masked, the merge identity; nothing
            # launches, and its K/V only travel on
            if step == n - 1:
                unused += [k_cur, v_cur]
        else:
            out_i, lse_i = flash_attention_with_lse(
                q, k_cur, v_cur, causal and src == my)
            acc, m, s = merge_shard(acc, m, s, out_i.float(), lse_i)
        if step < n - 1:
            k_cur, v_cur = C.ppermute((k_cur, v_cur), mesh, axis, perm)
    out = (acc / torch.clamp_min(s, 1e-30)[..., None]).to(orig_dtype)
    # a rank whose last visiting shard lay in its future never used it;
    # its rotation's backward exchange must still run (its peers wait)
    return C.depend(out, *unused)
