"""Nothing under benchmark/ imports JAX, the JAX package, bench.py,
bench_torch.py or chip_smoke.py, compared by the whole top-level name (the
port's name begins with the JAX package's); the reference imports nothing
of the port."""

import ast
import os

import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "taming_event_flow_tpu",
             "bench", "bench_torch", "chip_smoke"}
PORT = "taming_event_flow_tpu_torch"


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def _modules(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere_under_benchmark():
    seen = 0
    for path in _modules(tiny.BENCH_DIR):
        seen += 1
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"
    assert seen > 20


def test_the_whole_name_is_compared():
    # the port's name starts with the JAX package's and is allowed
    assert PORT.split(".")[0] not in FORBIDDEN
    assert "taming_event_flow_tpu" in FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(tiny.BENCH_DIR, "reference")
    for path in _modules(ref):
        tops = set(_imports(path))
        assert PORT not in tops and "harness" not in tops, path
