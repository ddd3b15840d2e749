"""The port stands alone: neither `deepsir_tpu_torch` nor `chip_smoke.py`
imports JAX, flax, optax, msgpack, tensorboardX or anything of the JAX
package, and
`chip_smoke.py` fails without a CUDA device."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "deepsir_tpu_torch"

_IMPORT_ALL = r"""
import sys
for name in ("jax", "flax", "optax", "msgpack", "tensorboardX"):
    sys.modules[name] = None          # any import of them raises ImportError
import importlib, pkgutil
import deepsir_tpu_torch
names = [m.name for m in pkgutil.walk_packages(deepsir_tpu_torch.__path__, "deepsir_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m == "deepsir_tpu" or m.startswith("deepsir_tpu.")
                or m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack", "tensorboardX")
                and sys.modules[m] is not None)
print(len(names), leaked)
assert not leaked, leaked
import torch.distributed as dist
assert not dist.is_initialized(), "importing the port started a process group"
"""


def test_port_and_chip_smoke_import_without_jax():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    count, leaked = res.stdout.split(maxsplit=1)
    assert int(count) >= 18 and leaked.strip() == "[]"


def test_sources_do_not_import_the_jax_package():
    pattern = re.compile(r"^\s*(from|import)\s+(deepsir_tpu|jax|flax|optax|msgpack|tensorboardX)"
                         r"\b(?!_torch)",
                         re.MULTILINE)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 19
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_kernel_sources_include_no_torch_headers():
    sources = sorted((PORT / "csrc").glob("*.cu"))
    assert [s.name for s in sources] == ["knn_topk.cu", "knn_windowed.cu",
                                         "match_argmin.cu", "match_bidir.cu"]
    for src in sources + sorted((PORT / "csrc").glob("*.cuh")):
        text = src.read_text()
        assert "torch/extension.h" not in text and "cutlass" not in text.lower()
        assert "#include <torch" not in text and "ATen" not in text
    for src in sources:
        assert "Replaces the TPU kernel deepsir_tpu/ops/pallas_" in src.read_text()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Without CUDA, and in a directory holding only chip_smoke.py, the script
    exits non-zero and never prints its result line."""
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    lines = res.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]


def test_build_finds_no_nvcc_and_says_so(monkeypatch, tmp_path):
    from deepsir_tpu_torch.ops import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    a = _build.library_path("knn_topk")
    assert a.parent == PORT / "_build" and a.name.startswith("knn_topk-")
    assert a != _build.library_path("match_argmin")
    assert _build.library_path("knn_windowed").name.startswith("knn_windowed-")
