"""The PyTorch port's transformer LM, weight transfer, device policy and
import isolation, held against the JAX package.

Weights are made by the JAX package from a seed, carried across as numpy
with `weights.params_from_jax`, and both packages run the same tokens on
the CPU (the port's flash wrapper runs its plain version there; the JAX
package's flash kernel runs in interpret mode). Logits agree to 1e-4:
the same float32 function through a dozen matrix products summed in
another order.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jax_tf
from deeplearning4j_tpu.serving import kv_cache as jax_kv
from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.models import transformer as tf
from deeplearning4j_tpu_torch.serving import kv_cache
from deeplearning4j_tpu_torch.weights import (params_from_jax,
                                              params_to_numpy)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "deeplearning4j_tpu_torch"
LOGIT_TOL = 1e-4

JAX_CFG = jax_tf.TransformerConfig(vocab_size=61, d_model=64, n_heads=2,
                                   n_layers=2, d_ff=128, max_len=128,
                                   interpret=True)
CFG = tf.TransformerConfig(vocab_size=61, d_model=64, n_heads=2,
                           n_layers=2, d_ff=128, max_len=128)


def _jax_params(seed=0):
    p = jax_tf.init_transformer_params(jax.random.PRNGKey(seed), JAX_CFG)
    # LN gains/biases and FFN biases start at 1/0; perturb them so the
    # affine parts are exercised too
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        p)
    return p


def _both(seed=0):
    jp = _jax_params(seed)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


def _tokens(seed, b, t):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (b, t)).astype(np.int32)


def _close(a, b, tol=LOGIT_TOL):
    np.testing.assert_allclose(a.detach().numpy() if torch.is_tensor(a)
                               else a, np.asarray(b), atol=tol, rtol=0)


class TestWeights:
    def test_round_trip_keeps_keys_and_values(self):
        jp, tp = _both()
        assert set(tp) == {"embed", "pos", "ln_f", "blocks"}
        assert set(tp["blocks"][0]) == {"ln1", "Wq", "Wk", "Wv", "Wo",
                                        "ln2", "W1", "b1", "W2", "b2"}
        back = params_to_numpy(tp)
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(jp)):
            np.testing.assert_array_equal(a, np.asarray(b))

    def test_bfloat16_crosses_bit_for_bit(self):
        a = jnp.asarray(np.linspace(-3, 3, 17, dtype=np.float32),
                        jnp.bfloat16)
        t = params_from_jax({"w": np.asarray(a)}, device="cpu")["w"]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(a.astype(jnp.float32)))
        assert params_to_numpy({"w": t})["w"].dtype == np.float32

    def test_dtype_cast_on_the_way_in(self):
        _, tp = _both()
        t = params_from_jax({"w": np.ones((2, 2), np.float32)},
                            device="cpu", dtype=torch.bfloat16)["w"]
        assert t.dtype == torch.bfloat16
        assert tp["embed"].dtype == torch.float32


class TestForward:
    @pytest.mark.parametrize("t", [16, 37])
    def test_logits_match_jax(self, t):
        jp, tp = _both(1)
        tok = _tokens(t, 3, t)
        ref = jax_tf.transformer_logits(jp, jnp.asarray(tok), JAX_CFG)
        out = tf.transformer_logits(tp, torch.from_numpy(tok), CFG)
        assert out.shape == (3, t, CFG.vocab_size)
        _close(out, ref)

    def test_layer_norm_matches_jax_in_bfloat16(self):
        """Statistics in float32, cast back BEFORE the affine: the bf16
        rounding lands where the JAX reference puts it."""
        rng = np.random.default_rng(3)
        x = rng.normal(size=(4, 64)).astype(np.float32) * 3 + 1
        g = rng.normal(size=(64,)).astype(np.float32)
        b = rng.normal(size=(64,)).astype(np.float32)
        jx, jg, jb = (jnp.asarray(a, jnp.bfloat16) for a in (x, g, b))
        ref = jax_tf._layer_norm({"g": jg, "b": jb}, jx)
        tx, tg, tb = (torch.from_numpy(a).bfloat16() for a in (x, g, b))
        out = tf._layer_norm({"g": tg, "b": tb}, tx)
        assert out.dtype == torch.bfloat16
        _close(out.float(), np.asarray(ref.astype(jnp.float32)), tol=3e-2)

    def test_too_long_sequence_raises(self):
        _, tp = _both()
        with pytest.raises(ValueError, match="exceeds max_len"):
            tf.transformer_logits(tp, torch.zeros((1, 129), dtype=torch.int32),
                                  CFG)


class TestKVCache:
    def test_prefill_then_decode_steps_match_jax(self):
        jp, tp = _both(2)
        tok = _tokens(5, 2, 11)
        jcache = jax_kv.init_cache(JAX_CFG, 2)
        jlog, jcache = jax_kv.prefill(jp, jnp.asarray(tok), jcache, JAX_CFG)
        cache = kv_cache.init_cache(CFG, 2, device="cpu")
        log, cache = kv_cache.prefill(tp, torch.from_numpy(tok), cache, CFG)
        _close(log, jlog)
        assert cache.cursor == 11
        nxt = _tokens(6, 5, 2)
        for step in range(5):
            jlog, jcache = jax_kv.decode_step(
                jp, jnp.asarray(nxt[step]), jcache, JAX_CFG)
            log, cache = kv_cache.decode_step(
                tp, torch.from_numpy(nxt[step]), cache, CFG)
            _close(log, jlog)
        _close(cache.layers[1]["k"], jcache.layers[1]["k"])

    def test_cache_bytes_and_bad_length(self):
        assert kv_cache.kv_cache_bytes(CFG, 3) == jax_kv.kv_cache_bytes(
            JAX_CFG, 3)
        with pytest.raises(ValueError, match="length must be >= 1"):
            kv_cache.init_cache(CFG, 1, length=0, device="cpu")


class TestGenerate:
    def test_naive_and_cached_greedy_tokens_match_jax(self):
        jp, tp = _both(3)
        prompt = _tokens(7, 2, 9)
        ref_naive = np.asarray(jax_tf.generate(jp, jnp.asarray(prompt),
                                               JAX_CFG, 6))
        ref_cached = np.asarray(jax_kv.generate_cached(
            jp, jnp.asarray(prompt), JAX_CFG, 6))
        naive = tf.generate(tp, torch.from_numpy(prompt), CFG, 6)
        cached = tf.generate(tp, torch.from_numpy(prompt), CFG, 6,
                             cache=True)
        np.testing.assert_array_equal(naive.numpy(), ref_naive)
        np.testing.assert_array_equal(cached.numpy(), ref_cached)

    def test_over_window_raises(self):
        _, tp = _both()
        with pytest.raises(ValueError, match="max_len"):
            kv_cache.generate_cached(
                tp, torch.zeros((1, 120), dtype=torch.int32), CFG, 9)


class TestDevicePolicy:
    def test_default_device_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            default_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tf.init_transformer_params(0, CFG)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kv_cache.init_cache(CFG, 1)

    def test_explicit_cpu_and_seeded_init(self):
        a = tf.init_transformer_params(5, CFG, device="cpu")
        b = tf.init_transformer_params(5, CFG, device="cpu")
        assert a["embed"].device.type == "cpu"
        assert torch.equal(a["blocks"][1]["W2"], b["blocks"][1]["W2"])
        assert not torch.equal(a["blocks"][0]["Wq"], a["blocks"][0]["Wk"])
        assert float(a["embed"].std()) == pytest.approx(0.02, rel=0.1)

    def test_float32_matmuls_keep_full_precision(self):
        import deeplearning4j_tpu_torch  # noqa: F401 — sets the policy
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False


class TestImportIsolation:
    def test_port_and_chip_smoke_import_no_jax(self):
        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "import deeplearning4j_tpu_torch.serving, "
                "deeplearning4j_tpu_torch.serving.server, "
                "deeplearning4j_tpu_torch.serving.fleetkv, "
                "deeplearning4j_tpu_torch.serving.fleet, "
                "deeplearning4j_tpu_torch.serving.router, "
                "deeplearning4j_tpu_torch.scaleout.api, "
                "deeplearning4j_tpu_torch.scaleout.rpc, "
                "deeplearning4j_tpu_torch.scaleout.statetracker, "
                "deeplearning4j_tpu_torch.utils.procs, "
                "deeplearning4j_tpu_torch.telemetry, "
                "deeplearning4j_tpu_torch.telemetry.device, "
                "deeplearning4j_tpu_torch.testing.chaos, "
                "deeplearning4j_tpu_torch.utils.statefile, "
                "deeplearning4j_tpu_torch.cli, "
                "deeplearning4j_tpu_torch.weights, chip_smoke; "
                "bad = [m for m in sys.modules if m == 'jax' "
                "or m.startswith('jax.') or m == 'deeplearning4j_tpu' "
                "or m.startswith('deeplearning4j_tpu.')]; "
                "print(bad); sys.exit(1 if bad else 0)")
        env = {k: v for k, v in os.environ.items()
               if k not in ("PYTHONPATH",)}
        res = subprocess.run([sys.executable, "-c", code, str(REPO)],
                             capture_output=True, text=True, timeout=120,
                             env=env, cwd=str(REPO))
        assert res.returncode == 0, res.stdout + res.stderr

    def test_no_source_file_imports_jax_or_the_jax_package(self):
        files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
        assert len(files) > 10
        for path in files:
            tree = ast.parse(path.read_text(), filename=str(path))
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                else:
                    continue
                for name in names:
                    top = name.split(".")[0]
                    assert top not in ("jax", "jaxlib",
                                       "deeplearning4j_tpu"), (
                        f"{path.relative_to(REPO)} imports {name}")
