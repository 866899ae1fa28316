"""The PyTorch port's ring attention gradients against the JAX package's
einsum ring on the CPU (tests/test_attention.py's TestRing
`test_grad_through_ring` shape: 4 ranks, T 32, d 8, causal): the einsum
ring and the flash ring (K1 with its lse on each visiting shard, the
plain versions of K2/K3 backward, a nonzero lse cotangent) both. Its
own file because JAX's ring gradient takes about half a minute to
compile. Forked gloo ranks, 120 s a group.

Tolerances as the JAX tests: einsum 5e-5, flash 1e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.attention import ring_attention as jring
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh
from deeplearning4j_tpu_torch.testing.ranks import run_ranks
from tests.test_torch_ring import GROUP_LIMIT, _joined, qkv, ring_rank

_REF = {}


def _jax_grads():
    if not _REF:
        mesh = jmake_mesh({"sp": 4}, devices=jax.devices()[:4])
        q, k, v = qkv(b=1, t=32, d=8)
        _REF["qkv"] = (q, k, v)
        _REF["grads"] = jax.grad(lambda q, k, v: jnp.sum(jring(
            q, k, v, mesh, axis="sp", causal=True) ** 2),
            argnums=(0, 1, 2))(q, k, v)
    return _REF["qkv"], _REF["grads"]


@pytest.mark.parametrize("local,atol", [("einsum", 5e-5), ("flash", 1e-4)])
def test_causal_ring_grads_match_jax(local, atol):
    (q, k, v), ref = _jax_grads()
    res = run_ranks(ring_rank, 4, 4, q, k, v, True, local, True,
                    timeout=GROUP_LIMIT)
    for i in range(3):
        got = _joined([r[1][i] for r in res])
        np.testing.assert_allclose(got, np.asarray(ref[i]), atol=atol)
