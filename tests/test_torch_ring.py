"""The PyTorch port's ring attention (deeplearning4j_tpu_torch/attention/
ring.py) held against the JAX package's `ring_attention` on the CPU, at
the shapes of tests/test_attention.py's TestRing / TestRingFlash.

The JAX function takes the global q/k/v on its virtual mesh; the port's
takes each rank's sequence shard on forked gloo ranks
(`testing/ranks.py`, 120 s a group), and the shards' outputs and
gradients are put back together here. The flash ring runs K1's plain
version on the CPU (as JAX's runs its kernel in interpret mode). Its
gradients are in test_torch_ring_grad.py and test_torch_ring_flash.py
(JAX's ring gradients take about half a minute each to compile).

Tolerances as the JAX tests: einsum ring forward 2e-5, gradients 5e-5;
flash ring forward 3e-5, gradients 1e-4.
"""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.attention import naive_attention, ring_attention \
    as jring
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh
from deeplearning4j_tpu_torch.attention.blockwise import NEG_INF
from deeplearning4j_tpu_torch.attention.ring import (merge_shard,
                                                     ring_attention)
from deeplearning4j_tpu_torch.parallel import make_mesh
from deeplearning4j_tpu_torch.testing.ranks import run_ranks

GROUP_LIMIT = 120.0


def qkv(b=2, t=64, d=16, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return tuple(np.asarray(jax.random.normal(k, (b, t, d), jnp.float32))
                 for k in ks)


def ring_rank(rank, n, q, k, v, causal, local, grad=False, batch_axis=None):
    """This rank's shard of the ring's output (and of the gradients of
    sum(out ** 2) over the whole sequence)."""
    axes = {"sp": n} if batch_axis is None else {batch_axis: 2, "sp": n}
    mesh = make_mesh(axes, device="cpu")
    i = mesh.axis_index("sp")
    tl = q.shape[1] // n
    rows = slice(None)
    if batch_axis is not None:
        bl = q.shape[0] // 2
        j = mesh.axis_index(batch_axis)
        rows = slice(j * bl, (j + 1) * bl)
    shard = [torch.from_numpy(a[rows, i * tl:(i + 1) * tl].copy())
             .requires_grad_(grad) for a in (q, k, v)]
    out = ring_attention(*shard, mesh, axis="sp", causal=causal,
                         batch_axis=batch_axis, local=local)
    if not grad:
        return out.detach().numpy()
    (out ** 2).sum().backward()
    return out.detach().numpy(), [s.grad.numpy() for s in shard]


def _joined(shards):
    return np.concatenate(shards, axis=1)


class TestEinsumRing:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_jax_ring_and_single_device(self, causal):
        mesh = jmake_mesh({"sp": 8}, devices=jax.devices()[:8])
        q, k, v = qkv(b=2, t=64, d=8)
        ref = np.asarray(jring(q, k, v, mesh, axis="sp", causal=causal))
        out = _joined(run_ranks(ring_rank, 8, 8, q, k, v, causal, "einsum",
                                timeout=GROUP_LIMIT))
        np.testing.assert_allclose(out, ref, atol=2e-5)
        np.testing.assert_allclose(
            out, np.asarray(naive_attention(q, k, v, causal=causal)),
            atol=2e-5)

    def test_dp_x_sp_composes(self):
        """batch_axis: each data group of the (data 2, sp 4) mesh runs
        its own ring over its rows."""
        jm = jmake_mesh({"dp": 2, "sp": 4})
        q, k, v = qkv(b=4, t=32, d=8)
        ref = np.asarray(jring(q, k, v, jm, axis="sp", causal=True,
                               batch_axis="dp"))
        res = run_ranks(ring_rank, 8, 4, q, k, v, True, "einsum", False,
                        "dp", timeout=GROUP_LIMIT)
        # rank = dp * 4 + sp: rows by dp, sequence by sp
        out = np.concatenate([_joined(res[4 * j:4 * j + 4])
                              for j in range(2)], axis=0)
        np.testing.assert_allclose(out, ref, atol=2e-5)

    def test_indivisible_sequence_raises(self):
        """The JAX error, on the global length the unequal shards add up
        to (60 positions over 8 ranks: shards of 8 and 7)."""
        mesh = jmake_mesh({"sp": 8}, devices=jax.devices()[:8])
        q, k, v = qkv(t=60)
        with pytest.raises(ValueError) as jerr:
            jring(q, k, v, mesh, axis="sp")

        def body(rank):
            mesh = make_mesh({"sp": 8}, device="cpu")
            lo, hi = [0, 8, 16, 24, 32, 39, 46, 53, 60][rank:rank + 2]
            shard = [torch.from_numpy(a[:, lo:hi].copy()) for a in (q, k, v)]
            try:
                ring_attention(*shard, mesh, axis="sp")
            except ValueError as e:
                return str(e)
            return None

        assert run_ranks(body, 8, timeout=GROUP_LIMIT) == \
            [str(jerr.value)] * 8


class TestFlashRing:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_jax_flash_ring(self, causal):
        """T_local = 256: the shape JAX's kernel-path test uses."""
        mesh = jmake_mesh({"sp": 4}, devices=jax.devices()[:4])
        q, k, v = qkv(b=1, t=1024, d=64)
        ref = np.asarray(jring(q, k, v, mesh, axis="sp", causal=causal,
                               local="flash", interpret=True))
        ref_einsum = np.asarray(jring(q, k, v, mesh, axis="sp",
                                      causal=causal))
        out = _joined(run_ranks(ring_rank, 4, 4, q, k, v, causal, "flash",
                                timeout=GROUP_LIMIT))
        np.testing.assert_allclose(out, ref, atol=3e-5)
        np.testing.assert_allclose(out, ref_einsum, atol=3e-5)

    def test_unknown_local_engine_raises(self):
        mesh = jmake_mesh({"sp": 4}, devices=jax.devices()[:4])
        q, k, v = qkv(b=1, t=256, d=8)
        with pytest.raises(ValueError, match="local engine") as jerr:
            jring(q, k, v, mesh, axis="sp", local="pallas")

        def body(rank):
            mesh = make_mesh({"sp": 4}, device="cpu")
            shard = [torch.from_numpy(a[:, :64].copy()) for a in (q, k, v)]
            try:
                ring_attention(*shard, mesh, axis="sp", local="pallas")
            except ValueError as e:
                return str(e)
            return None

        assert run_ranks(body, 4, timeout=GROUP_LIMIT) == \
            [str(jerr.value)] * 4


class TestMergeSentinels:
    """The log-space merge's guards (ROADMAP Queue 3's watch item): a
    fully masked shard is the identity whatever the fold order, also
    when folded FIRST (the carry still at its -inf init), and K1's +1e30
    lse of a row that saw no key counts as that identity."""

    def _shards(self, n=3, rows=5, d=4, seed=0):
        rng = np.random.default_rng(seed)
        return [(torch.from_numpy(rng.normal(size=(rows, d))
                                  .astype(np.float32)),
                 torch.from_numpy(rng.normal(size=rows).astype(np.float32)))
                for _ in range(n)]

    def _fold(self, shards):
        rows, d = shards[0][0].shape
        acc = torch.zeros(rows, d)
        m = torch.full((rows,), NEG_INF)
        s = torch.zeros(rows)
        for out_i, lse_i in shards:
            acc, m, s = merge_shard(acc, m, s, out_i, lse_i)
        return (acc / torch.clamp_min(s, 1e-30)[:, None]).numpy()

    def _exact(self, shards):
        lse = np.stack([l.numpy() for _, l in shards])     # (n, rows)
        w = np.exp(lse - lse.max(0))
        w /= w.sum(0)
        return sum(w[i][:, None] * shards[i][0].numpy()
                   for i in range(len(shards)))

    @pytest.mark.parametrize("sentinel", [NEG_INF, -NEG_INF],
                             ids=["future_shard", "k1_fully_masked"])
    def test_identity_shard_in_every_fold_position(self, sentinel):
        real = self._shards()
        rows, d = real[0][0].shape
        empty = (torch.zeros(rows, d), torch.full((rows,), sentinel))
        want = self._exact(real)
        for order in itertools.permutations(range(len(real) + 1)):
            shards = [(real + [empty])[i] for i in order]
            np.testing.assert_allclose(self._fold(shards), want, atol=1e-6,
                                       err_msg=f"fold order {order}")

    def test_only_identity_shards_give_zero(self):
        rows, d = 5, 4
        empty = [(torch.zeros(rows, d), torch.full((rows,), NEG_INF)),
                 (torch.zeros(rows, d), torch.full((rows,), -NEG_INF))]
        out = self._fold(empty)
        assert np.isfinite(out).all() and not out.any()
