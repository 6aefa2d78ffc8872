"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: the port's own name begins with the JAX
package's), the references import nothing of the port, and a run with
no card fails without a result."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest
from portbench_scratch import REPO

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in (REPO / "portbench").rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((REPO / "portbench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"repro_torch"})


def test_guard_compares_whole_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.launch", "jaxtyping",
                                      "torch"]) == []
    assert harness.forbidden_modules(["repro.launch", "jax", "flax.linen", "jaxlib"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_no_card_no_result():
    """On a host without a card the command exits non-zero and prints no
    result: it does not fall back to the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    cell = json.loads((REPO / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    p = subprocess.run([sys.executable, str(REPO / "portbench" / "run.py"), "--workload", cell,
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert p.returncode != 0 and "CUDA" in p.stderr
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
