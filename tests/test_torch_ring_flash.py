"""The PyTorch port's flash ring attention held against the JAX package
at tests/test_attention.py's TestRingFlash shape: causal, against JAX's
flash ring (its Pallas kernel in interpret mode) forward and gradients;
non-causal, against single-device attention's gradients, as JAX's own
test holds its flash ring. 4 ranks, T 1024 (T_local 256), head dim 64.
The port's runs K1's plain version
on the visiting shards (mask-free for past shards, causal on the
diagonal, none for future ones) and K2/K3's plain version backward,
with the merge's nonzero lse cotangent. Its own file because JAX's
interpreted backward takes about half a minute.

Tolerance as JAX's test: 1e-4 on each gradient, 3e-5 forward.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from deeplearning4j_tpu.attention import naive_attention, ring_attention \
    as jring
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh
from deeplearning4j_tpu_torch.testing.ranks import run_ranks
from tests.test_torch_ring import GROUP_LIMIT, _joined, qkv, ring_rank


def test_causal_flash_ring_grads_match_jax():
    mesh = jmake_mesh({"sp": 4}, devices=jax.devices()[:4])
    q, k, v = qkv(b=1, t=1024, d=64)

    def loss(q, k, v):
        return jnp.sum(jring(q, k, v, mesh, axis="sp", causal=True,
                             local="flash", interpret=True) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    naive = jax.grad(lambda q, k, v: jnp.sum(naive_attention(
        q, k, v, causal=True) ** 2), argnums=(0, 1, 2))(q, k, v)
    res = run_ranks(ring_rank, 4, 4, q, k, v, True, "flash", True,
                    timeout=GROUP_LIMIT)
    np.testing.assert_allclose(
        _joined([r[0] for r in res]),
        np.asarray(naive_attention(q, k, v, causal=True)), atol=3e-5)
    for i in range(3):
        got = _joined([r[1][i] for r in res])
        np.testing.assert_allclose(got, np.asarray(ref[i]), atol=1e-4)
        np.testing.assert_allclose(got, np.asarray(naive[i]), atol=1e-4)


def test_noncausal_flash_ring_grads_match_single_device():
    """Every visiting shard through K1's plain version with its lse and
    the mask-free kernel; K2/K3's plain version gets the merge's nonzero
    lse cotangent."""
    q, k, v = qkv(b=1, t=1024, d=64)
    naive = jax.grad(lambda q, k, v: jnp.sum(naive_attention(
        q, k, v, causal=False) ** 2), argnums=(0, 1, 2))(q, k, v)
    res = run_ranks(ring_rank, 4, 4, q, k, v, False, "flash", True,
                    timeout=GROUP_LIMIT)
    for i in range(3):
        got = _joined([r[1][i] for r in res])
        np.testing.assert_allclose(got, np.asarray(naive[i]), atol=1e-4)
