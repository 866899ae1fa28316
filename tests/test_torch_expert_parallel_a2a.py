"""The PyTorch port's expert parallelism with all-to-all dispatch held
against the JAX package's on the CPU: the a2a cases of JAX's
TestExpertParallel (8 experts, d 16, hidden 32, 64 tokens, expert axis
4), each also against the JAX function's output on the same parameters.
The dense cases are in test_torch_expert_parallel.py. Forked gloo ranks
(`testing/ranks.py`, 120 s a group); the JAX references run here before
the ranks fork.

Tolerances as JAX's tests: outputs 1e-6, losses rtol 1e-6, a2a against
dense parameters 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deeplearning4j_tpu.parallel import expert_parallel as jep
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu_torch.parallel import expert_parallel as ep
from deeplearning4j_tpu_torch.parallel import make_mesh
from deeplearning4j_tpu_torch.testing.ranks import run_ranks

GROUP_LIMIT = 120.0


def _setup(n_experts=8, d=16):
    params = jep.init_moe_params(jax.random.PRNGKey(0), n_experts, d, 32)
    x = jax.random.normal(jax.random.PRNGKey(1), (64, d))
    y = jax.random.normal(jax.random.PRNGKey(2), (64, d))
    return params, x, y


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jmesh4():
    return jmake_mesh({"expert": 4}, devices=jax.devices()[:4])


def _rank(rank, axes, what, params, x, y=None, data_axis=None, **kw):
    mesh = make_mesh(axes, device="cpu")
    x = torch.from_numpy(np.array(x))
    if what == "dense":
        return ep.moe_apply(_t(params), x, mesh, data_axis=data_axis).numpy()
    if what == "a2a":
        out, dropped = ep.moe_apply_a2a(_t(params), x, mesh,
                                        data_axis=data_axis,
                                        return_stats=True, **kw)
        return out.numpy(), int(dropped)
    new, loss = ep.moe_grad_step(_t(params), x,
                                 torch.from_numpy(np.array(y)), mesh,
                                 data_axis=data_axis, **kw)
    return {k: v.numpy() for k, v in new.items()}, float(loss)


def _close_trees(a, b, atol):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], np.asarray(b[k]), atol=atol,
                                   err_msg=k)


class TestExpertParallelA2A:
    def test_a2a_matches_reference_at_ample_capacity(self):
        params, x, _ = _setup()
        ref = np.asarray(jep.moe_reference(params, x))
        jout, jdrop = jep.moe_apply_a2a(params, x, _jmesh4(),
                                        capacity_factor=8.0,
                                        return_stats=True)
        for out, dropped in run_ranks(_rank, 4, {"expert": 4}, "a2a",
                                      _np(params), np.asarray(x),
                                      capacity_factor=8.0,
                                      timeout=GROUP_LIMIT):
            assert dropped == int(jdrop) == 0
            np.testing.assert_allclose(out, ref, atol=1e-6)
            np.testing.assert_allclose(out, np.asarray(jout), atol=1e-6)

    def test_a2a_drops_oversubscribed_tokens_and_accounts(self):
        """All-zero gate: every token ties onto expert 0; at capacity
        factor 1 each shard keeps `cap` of them, the rest drop (output 0)
        and the stats count them exactly, as in JAX."""
        params, x, _ = _setup()
        rig = dict(params)
        rig["gate"] = jnp.zeros_like(params["gate"])
        n, e = x.shape[0], params["W1"].shape[0]
        cap = -(-(n // 4) // e)
        expected_drop = n - 4 * cap
        jout, jdrop = jep.moe_apply_a2a(rig, x, _jmesh4(),
                                        capacity_factor=1.0,
                                        return_stats=True)
        assert int(jdrop) == expected_drop
        ref = np.asarray(jep.moe_reference(rig, x))
        for out, dropped in run_ranks(_rank, 4, {"expert": 4}, "a2a",
                                      _np(rig), np.asarray(x),
                                      capacity_factor=1.0,
                                      timeout=GROUP_LIMIT):
            assert dropped == expected_drop
            zero_rows = ~out.any(axis=1)
            assert zero_rows.sum() == expected_drop
            np.testing.assert_allclose(out[~zero_rows], ref[~zero_rows],
                                       atol=1e-6)
            np.testing.assert_allclose(out, np.asarray(jout), atol=1e-6)

    def test_a2a_grad_step_matches_dense_at_ample_capacity(self):
        params, x, y = _setup()
        jp2, jl = jep.moe_grad_step(params, x, y, _jmesh4(), dispatch="a2a",
                                    capacity_factor=8.0)
        dense = run_ranks(_rank, 4, {"expert": 4}, "grad", _np(params),
                          np.asarray(x), np.asarray(y), timeout=GROUP_LIMIT)
        a2a = run_ranks(_rank, 4, {"expert": 4}, "grad", _np(params),
                        np.asarray(x), np.asarray(y), dispatch="a2a",
                        capacity_factor=8.0, timeout=GROUP_LIMIT)
        np.testing.assert_allclose(a2a[0][1], dense[0][1], rtol=1e-6)
        np.testing.assert_allclose(a2a[0][1], float(jl), rtol=1e-6)
        _close_trees(a2a[0][0], dense[0][0], 1e-5)
        _close_trees(a2a[0][0], jp2, 1e-5)

    def test_a2a_ep_x_dp_composes(self):
        params, x, _ = _setup()
        ref = np.asarray(jep.moe_reference(params, x))
        jout = jep.moe_apply_a2a(params, x,
                                 jmake_mesh({"expert": 4, "data": 2}),
                                 data_axis="data", capacity_factor=8.0)
        for out, _ in run_ranks(_rank, 8, {"expert": 4, "data": 2}, "a2a",
                                _np(params), np.asarray(x), "data",
                                capacity_factor=8.0, timeout=GROUP_LIMIT):
            np.testing.assert_allclose(out, ref, atol=1e-6)
            np.testing.assert_allclose(out, np.asarray(jout), atol=1e-6)

