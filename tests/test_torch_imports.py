"""The port stands alone: no module of src/repro_torch and no line of
chip_smoke.py imports jax or the JAX package (read with ast).  Its layers
import one way: the engine imports the kernels and the kernels import the
core, so no module of core/ imports a kernel inside a function body and
core/network.py imports none; each module of both loads first in a fresh
interpreter."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "repro"}
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = sorted(set(imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_has_sources():
    assert len(SOURCES) > 10


# --- one-way layers: the engine imports the kernels, the kernels the core ---
PORT = ROOT / "src" / "repro_torch"
CORE = sorted((PORT / "core").glob("*.py"))
KERNELS = "repro_torch.kernels"


def imports_kernels(node) -> bool:
    """Whether ``node`` imports from the kernel layer."""
    if isinstance(node, ast.Import):
        return any(a.name == KERNELS or a.name.startswith(KERNELS + ".")
                   for a in node.names)
    if isinstance(node, ast.ImportFrom) and node.level == 0:
        return (node.module == KERNELS
                or node.module.startswith(KERNELS + ".")
                or (node.module == "repro_torch"
                    and any(a.name == "kernels" for a in node.names)))
    return False


@pytest.mark.parametrize("path", CORE, ids=lambda p: p.name)
def test_core_imports_the_kernels_only_at_module_level(path):
    """No module of core/ reaches into the kernels from a function body,
    and the network layer, which the kernels' plain versions build on,
    imports none at all: a kernel route is chosen once, in the engine."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bodies = [n for n in ast.walk(tree)
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda))]
    inner = sorted({i.lineno for f in bodies for i in ast.walk(f)
                    if imports_kernels(i)})
    assert not inner, f"{path.name} imports a kernel in a function " \
                      f"body at lines {inner}"
    if path.name == "network.py":
        anywhere = [i.lineno for i in ast.walk(tree) if imports_kernels(i)]
        assert not anywhere, f"network.py imports a kernel at {anywhere}"


def layer_modules():
    """Every module of core/ and kernels/, by import name."""
    paths = sorted((PORT / "core").glob("*.py")) \
        + sorted((PORT / "kernels").rglob("*.py"))
    names = []
    for p in paths:
        parts = p.relative_to(PORT.parent).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__"
                              else parts))
    return names


@pytest.mark.parametrize("module", layer_modules())
def test_each_layer_module_imports_first_in_a_fresh_interpreter(module):
    """Imported first, on the CPU, each module of the core and the kernels
    loads: the core and the kernels import each other one way only."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, "-c", f"import {module}"],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
