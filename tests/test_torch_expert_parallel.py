"""The PyTorch port's expert parallelism (deeplearning4j_tpu_torch/
parallel/expert_parallel.py) held against the JAX package's on the CPU:
JAX's TestExpertParallel cases (8 experts, d 16, hidden 32, 64 tokens,
expert axis 4), each also against the JAX function's output on the same
parameters (JAX's `init_moe_params`, carried across as numpy arrays).
Forked gloo ranks (`testing/ranks.py`, 120 s a group); the JAX
references run here before the ranks fork.

Tolerances as JAX's tests: outputs, losses and updated parameters 1e-6
(a2a vs dense parameters 1e-5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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


class TestExpertParallel:
    def test_forward_matches_dense_reference_and_jax(self):
        params, x, _ = _setup()
        ref = np.asarray(jep.moe_reference(params, x))
        jout = np.asarray(jep.moe_apply(params, x, _jmesh4()))
        outs = run_ranks(_rank, 4, {"expert": 4}, "dense", _np(params),
                         np.asarray(x), timeout=GROUP_LIMIT)
        for out in outs:
            np.testing.assert_allclose(out, ref, atol=1e-6)
            np.testing.assert_allclose(out, jout, atol=1e-6)
        mine = ep.moe_reference(_t(_np(params)),
                                torch.from_numpy(np.array(x))).numpy()
        np.testing.assert_allclose(mine, ref, atol=1e-6)

    def test_grad_step_matches_and_router_learns(self):
        params, x, y = _setup()

        def ref_loss(p):
            return jnp.mean((jep.moe_reference(p, x) - y) ** 2)

        ls, gs = jax.value_and_grad(ref_loss)(params)
        p_ref = jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, params, gs)
        jp2, jl = jep.moe_grad_step(params, x, y, _jmesh4())
        res = run_ranks(_rank, 4, {"expert": 4}, "grad", _np(params),
                        np.asarray(x), np.asarray(y), timeout=GROUP_LIMIT)
        for p2, loss in res:
            assert abs(loss - float(ls)) < 1e-6
            assert abs(loss - float(jl)) < 1e-6
            _close_trees(p2, p_ref, 1e-6)
            _close_trees(p2, jp2, 1e-6)
            # the router gets gradient (gate params move)
            assert np.abs(p2["gate"] - np.asarray(params["gate"])).max() > 0

    def test_indivisible_expert_count_raises(self):
        params, x, _ = _setup(n_experts=6)
        with pytest.raises(ValueError, match="divisible") as jerr:
            jep.moe_apply(params, x, _jmesh4())
        # numpy copies made here: a forked rank must not touch JAX
        params, x = _np(params), np.asarray(x)

        def body(rank):
            mesh = make_mesh({"expert": 4}, device="cpu")
            try:
                ep.moe_apply(_t(params), torch.from_numpy(np.array(x)), mesh)
            except ValueError as e:
                return str(e)
            return None

        assert run_ranks(body, 4, timeout=GROUP_LIMIT) == \
            [str(jerr.value)] * 4

    def test_unknown_dispatch_raises(self):
        params, x, y = _setup()
        with pytest.raises(ValueError, match="dispatch") as jerr:
            jep.moe_grad_step(params, x, y, _jmesh4(), dispatch="sparse")
        with pytest.raises(ValueError) as err:
            ep.moe_grad_step(_t(_np(params)), torch.from_numpy(np.array(x)),
                             torch.from_numpy(np.array(y)), None,
                             dispatch="sparse")
        assert str(err.value) == str(jerr.value)

    def test_ep_x_dp_composes(self):
        params, x, y = _setup()
        jp2, jl = jep.moe_grad_step(params, x, y,
                                    jmake_mesh({"expert": 4, "data": 2}),
                                    data_axis="data")
        one = run_ranks(_rank, 4, {"expert": 4}, "grad", _np(params),
                        np.asarray(x), np.asarray(y), timeout=GROUP_LIMIT)
        two = run_ranks(_rank, 8, {"expert": 4, "data": 2}, "grad",
                        _np(params), np.asarray(x), np.asarray(y), "data",
                        timeout=GROUP_LIMIT)
        np.testing.assert_allclose(two[0][1], one[0][1], rtol=1e-6)
        np.testing.assert_allclose(two[0][1], float(jl), rtol=1e-6)
        for p2, _ in two:
            _close_trees(p2, one[0][0], 1e-6)
            _close_trees(p2, jp2, 1e-6)
