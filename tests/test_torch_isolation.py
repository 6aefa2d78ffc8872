"""The port stands alone and never hides the device.

* `src/repro_torch`, `chip_smoke.py`, `examples/quickstart_torch.py` and
  `examples/multi_client_torch.py` import neither ``jax`` nor the JAX
  package ``repro`` (an AST scan), and every module of the port and both
  examples import in a process where ``jax`` and ``repro`` cannot be
  imported.
* On a host without CUDA, an entry point asked for the card raises (the
  serving pool's ``device_backend="torch"`` too), and `chip_smoke.py`
  exits non-zero without printing a result, also from a directory that
  holds nothing else of the repo.
* `examples/quickstart_torch.py --device cpu` runs and streams fewer
  bytes than full-model updates would; `examples/multi_client_torch.py
  --device cpu` serves two clients at small frames.
"""
import ast
import os
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


QUICKSTART = ROOT / "examples" / "quickstart_torch.py"
MULTI_CLIENT = ROOT / "examples" / "multi_client_torch.py"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", QUICKSTART,
                                         MULTI_CLIENT]


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
    assert {"repro_torch.core.batched", "repro_torch.core.timing",
            "repro_torch.serving.engine",
            "repro_torch.sim.multiclient"} <= set(names)
    examples = [str(QUICKSTART), str(MULTI_CLIENT)]
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib, importlib.util\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            f"for i, path in enumerate({examples!r}):\n"
            "    spec = importlib.util.spec_from_file_location(f'ex{i}', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
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


def test_scheme_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the test is for hosts without one")
    from repro_torch.data.video import SyntheticVideo, VideoConfig
    from repro_torch.models.seg.student import SegConfig, make_student
    from repro_torch.models.seg.teacher import train_teacher
    from repro_torch.sim.runner import run_scheme
    from repro_torch.sim.seg_world import SegWorld, pretrain_student

    seg = SegConfig(n_classes=5)
    world = SegWorld.make(VideoConfig(height=16, width=16, fps=1.0, duration=4.0), seg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_scheme("ams", world, make_student(seg, 0, "cuda"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain_student(seg, steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_teacher(SyntheticVideo(VideoConfig(height=16, width=16)), 5, steps=1)
    r = subprocess.run([sys.executable, str(QUICKSTART)],
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr


def test_quickstart_runs_on_the_cpu():
    r = subprocess.run([sys.executable, str(QUICKSTART), "--device", "cpu"],
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    last = r.stdout.strip().splitlines()[-1]
    m = re.search(r"streamed (\d+) bytes over 30 phases; full-model streaming "
                  r"would be (\d+) bytes \(([\d.]+)x more\)", last)
    assert m, last
    streamed, full = int(m.group(1)), int(m.group(2))
    assert 0 < streamed < full and float(m.group(3)) > 1.0


def test_serving_torch_backend_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the test is for hosts without one")
    from repro_torch.serving import (GPUPool, ServingConfig, ServingEngine,
                                     StubSession)

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPUPool(2, device_backend="torch")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine([StubSession(0)], cfg=ServingConfig(
            duration=10.0, device_backend="torch"))
    r = subprocess.run([sys.executable, str(MULTI_CLIENT), "--clients", "1"],
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr


def test_multi_client_example_runs_on_the_cpu():
    # One intra-op thread: torch otherwise starts a thread per core in the
    # subprocess, beside the test workers that already load every core;
    # oversubscribed so, the ~15 s example ran past the 300 s limit. With
    # one thread it takes about as long alone as with all of them.
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(MULTI_CLIENT), "--device", "cpu",
                        "--clients", "2", "--duration", "20", "--size", "24",
                        "--fuse-train", "2"],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    m = re.search(r"clients=2 policy=fair gpus=1 mean mIoU=([\d.]+) .* "
                  r"served=(\d+)", lines[0])
    assert m, lines[0]
    assert 0.0 < float(m.group(1)) <= 1.0 and int(m.group(2)) >= 2
    assert sum(line.startswith("  client ") for line in lines) == 2


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
