"""The PyTorch port's pipeline parallelism (deeplearning4j_tpu_torch/
parallel/pipeline.py) held against the JAX package's on the CPU: JAX's
TestPipelineParallel cases (4 stages, width 16, 6 microbatches of 8),
each also against the JAX function's output on the same parameters
(JAX's `init_pipeline_params`, carried across as numpy arrays). Forked
gloo ranks (`testing/ranks.py`, 120 s a group); the JAX references run
here before the ranks fork.

Tolerances as JAX's tests: outputs, loss and updated parameters 1e-6
against the sequential ground truth; pp x dp loss rtol 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel import pipeline as jpipe
from deeplearning4j_tpu_torch.parallel import make_mesh
from deeplearning4j_tpu_torch.parallel import pipeline as pipe
from deeplearning4j_tpu_torch.testing.ranks import run_ranks

GROUP_LIMIT = 120.0


def _setup(n_stages=4, width=16, m=6, b=8):
    params = jpipe.init_pipeline_params(jax.random.PRNGKey(0), n_stages,
                                        width)
    xm = jax.random.normal(jax.random.PRNGKey(1), (m, b, width))
    ym = jax.random.normal(jax.random.PRNGKey(2), (m, b, width))
    return params, xm, ym


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _rank(rank, axes, what, params, xm, ym=None, data_axis=None):
    mesh = make_mesh(axes, device="cpu")
    xm = torch.from_numpy(np.array(xm))
    if what == "apply":
        return pipe.pipeline_apply(_t(params), xm, mesh,
                                   data_axis=data_axis).numpy()
    new, loss = pipe.pipeline_grad_step(
        _t(params), xm, torch.from_numpy(np.array(ym)), mesh,
        data_axis=data_axis)
    return {k: v.numpy() for k, v in new.items()}, float(loss)


class TestPipelineParallel:
    def test_forward_matches_sequential_and_jax(self):
        params, xm, _ = _setup()
        jmesh = jmake_mesh({"pipe": 4}, devices=jax.devices()[:4])
        jout = np.asarray(jpipe.pipeline_apply(params, xm, jmesh))
        ref = np.stack([np.asarray(jpipe.sequential_apply(params, xm[i]))
                        for i in range(xm.shape[0])])
        outs = run_ranks(_rank, 4, {"pipe": 4}, "apply", _np(params),
                         np.asarray(xm), timeout=GROUP_LIMIT)
        for out in outs:  # the psum hands the outputs to every stage
            np.testing.assert_allclose(out, ref, atol=1e-6)
            np.testing.assert_allclose(out, jout, atol=1e-6)
        # the port's own ground truth agrees with JAX's
        seq = torch.stack([pipe.sequential_apply(_t(params),
                                                 torch.from_numpy(
                                                     np.array(xm[i])))
                           for i in range(xm.shape[0])]).numpy()
        np.testing.assert_allclose(seq, ref, atol=1e-6)

    def test_grad_step_matches_sequential_and_jax(self):
        params, xm, ym = _setup()
        jmesh = jmake_mesh({"pipe": 4}, devices=jax.devices()[:4])
        jp2, jloss = jpipe.pipeline_grad_step(params, xm, ym, jmesh)

        def seq_loss(p):
            out = jnp.stack([jpipe.sequential_apply(p, xm[i])
                             for i in range(xm.shape[0])])
            return jnp.mean((out - ym) ** 2)

        ls, gs = jax.value_and_grad(seq_loss)(params)
        p_ref = jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, params, gs)
        res = run_ranks(_rank, 4, {"pipe": 4}, "grad", _np(params),
                        np.asarray(xm), np.asarray(ym), timeout=GROUP_LIMIT)
        for p2, loss in res:
            assert abs(loss - float(ls)) < 1e-6
            assert abs(loss - float(jloss)) < 1e-6
            for name in ("W", "b"):
                np.testing.assert_allclose(p2[name], np.asarray(p_ref[name]),
                                           atol=1e-6)
                np.testing.assert_allclose(p2[name], np.asarray(jp2[name]),
                                           atol=1e-6)

    def test_pp_x_dp_composes(self):
        params, xm, ym = _setup()
        jmesh = jmake_mesh({"pipe": 4, "data": 2})
        jp2, jloss = jpipe.pipeline_grad_step(params, xm, ym, jmesh,
                                              data_axis="data")
        one = run_ranks(_rank, 4, {"pipe": 4}, "grad", _np(params),
                        np.asarray(xm), np.asarray(ym), timeout=GROUP_LIMIT)
        two = run_ranks(_rank, 8, {"pipe": 4, "data": 2}, "grad",
                        _np(params), np.asarray(xm), np.asarray(ym), "data",
                        timeout=GROUP_LIMIT)
        np.testing.assert_allclose(two[0][1], one[0][1], rtol=1e-5)
        np.testing.assert_allclose(two[0][1], float(jloss), rtol=1e-5)
        for p2, _ in two:
            for name in ("W", "b"):
                np.testing.assert_allclose(p2[name], one[0][0][name],
                                           atol=1e-6)
                np.testing.assert_allclose(p2[name], np.asarray(jp2[name]),
                                           atol=1e-6)

    def test_stage_count_must_match_mesh(self):
        params, xm, _ = _setup(n_stages=3)
        jmesh = jmake_mesh({"pipe": 4}, devices=jax.devices()[:4])
        with pytest.raises(ValueError, match="stages") as jerr:
            jpipe.pipeline_apply(params, xm, jmesh)
        # numpy copies made here: a forked rank must not touch JAX
        params, xm = _np(params), np.asarray(xm)

        def body(rank):
            mesh = make_mesh({"pipe": 4}, device="cpu")
            try:
                pipe.pipeline_apply(_t(params), torch.from_numpy(np.array(xm)),
                                    mesh)
            except ValueError as e:
                return str(e)
            return None

        assert run_ranks(body, 4, timeout=GROUP_LIMIT) == \
            [str(jerr.value)] * 4

    def test_init_pipeline_params_shapes_and_range(self):
        gen = torch.Generator().manual_seed(0)
        p = pipe.init_pipeline_params(gen, 4, 16)
        jp = jpipe.init_pipeline_params(jax.random.PRNGKey(0), 4, 16)
        for name in ("W", "b"):
            assert tuple(p[name].shape) == tuple(jp[name].shape)
            assert p[name].dtype == torch.float32
        assert float(p["W"].abs().max()) <= 0.5 / 16
        assert not p["b"].any()
