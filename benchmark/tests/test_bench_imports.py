"""The check that JAX stayed out of the process compares whole
top-level names, the plain references import nothing of the program,
and the serving harness imports nothing of one model."""

import ast
import subprocess
import sys

from harness import common


def test_whole_top_level_names():
    mods = {"deeplearning4j_tpu_torch": 1,
            "deeplearning4j_tpu_torch.serving": 1, "numpy": 1,
            "jaxtyping": 1, "flaxen": 1}
    assert common.forbidden_loaded(mods) == []
    for bad in ("jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                "deeplearning4j_tpu", "deeplearning4j_tpu.nn"):
        assert common.forbidden_loaded({**mods, bad: 1}) == \
            [bad.split(".")[0]]


def test_reference_sources_import_nothing_of_the_program():
    for path in (common.BENCH_DIR / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert not n.startswith("deeplearning4j_tpu"), (path, n)
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax")


def test_reference_loads_without_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import reference.gpt2, reference.mlp; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('deeplearning4j') or m.split('.')[0] in "
            "('jax', 'flax')))" % str(common.BENCH_DIR))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_harness_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import harness.serve, harness.train_dp; "
            "from harness import common; "
            "common.served_model({'model_type': 'gpt2'}); "
            "print(common.forbidden_loaded())"
            % (str(common.BENCH_DIR), str(common.ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_serving_harness_imports_no_model():
    # a served model's weights, engine and reference come from its
    # `models/<model_type>.py`, never from the harness itself
    for rel in ("harness/serve.py", "control.py"):
        text = (common.BENCH_DIR / rel).read_text()
        for node in ast.walk(ast.parse(text)):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [f"{node.module}.{a.name}" for a in node.names]
                mods.append(node.module or "")
            for m in mods:
                assert m not in ("harness.lm", "harness.weights",
                                 "reference.gpt2"), (rel, m)
        for word in ("gpt2", "for_transformer"):
            assert word not in text, (rel, word)
