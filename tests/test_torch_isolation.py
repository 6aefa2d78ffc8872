"""The port stands alone and never hides the device.

* `src/repro_torch` and `chip_smoke.py` import neither ``jax`` nor the JAX
  package ``repro`` (an AST scan), and every module of the port imports
  in a process where ``jax`` and ``repro`` cannot be imported.
* On a host without CUDA, an entry point asked for the card raises, and
  `chip_smoke.py` exits non-zero without printing a result, also from a
  directory that holds nothing else of the repo.
"""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_jax_or_repro_imports():
    bad = []
    for path in _port_sources():
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad
    assert len(_port_sources()) > 20


def test_every_module_imports_without_jax():
    import repro_torch

    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert "repro_torch.core.batched" in names
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the test is for hosts without one")
    from repro_torch.models.seg.student import SegConfig, make_student, params_from_numpy

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_student(SegConfig(n_classes=5))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"w": np.zeros(3, np.float32)}, device="cuda")


def test_llm_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the test is for hosts without one")
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models.registry import build

    cfg = get_smoke("gemma2-9b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.serve(cfg, {}, torch.zeros(1, 4, dtype=torch.int64), 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "gemma2-9b", "--tokens", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build(cfg).init(torch.Generator())


def _run_smoke(cwd: Path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the test is for hosts without one")
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        r = _run_smoke(cwd)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
        assert not (tmp_path / "build").exists()
