"""Nothing the harness or the reference imports is JAX or the JAX package
(top-level names compared whole: the port's own name begins with the JAX
package's), and the reference imports nothing of the port."""
import ast

import pytest

from benchmark import harness

FILES = sorted(p for p in harness.HERE.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), tops


@pytest.mark.parametrize("path", sorted((harness.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert tops <= {"__future__", "typing", "numpy", "torch", "benchmark"}, tops
    assert all(m.startswith("benchmark.reference") for m in _imports(path)
               if m.split(".")[0] == "benchmark")


def test_forbidden_modules_by_whole_name(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "deepsir_tpu_torch_fake", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax.numpy"]


def test_a_run_loads_no_jax():
    """The port and the harness, imported in a fresh process, hold neither."""
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, %r); import benchmark.run, benchmark.harness as h; "
            "import benchmark.drivers.eval, benchmark.drivers.train, benchmark.calibrate; "
            "import deepsir_tpu_torch.training, deepsir_tpu_torch.models.network; "
            "print(h.forbidden_modules())" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
