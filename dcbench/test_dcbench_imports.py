"""Nothing of the benchmark loads JAX or the JAX package, comparing
top-level module names whole, and the reference imports nothing of the
port (CPU, no card)."""
import ast
import subprocess
import sys
from pathlib import Path

from dcbench import harness

BENCH = Path(harness.BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not imported_tops(f) & FORBIDDEN, f


def test_the_reference_imports_nothing_of_the_port():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        tops = imported_tops(f)
        assert "repro_torch" not in tops and not tops & FORBIDDEN, f
        assert "dcbench" not in tops or f.name == "__init__.py", f


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake_probe", sys)
    assert harness.forbidden_modules() == [] or \
        set(harness.forbidden_modules()) <= FORBIDDEN
    monkeypatch.setitem(sys.modules, "repro.core.fake_probe", sys)
    assert "repro" in harness.forbidden_modules()


def test_a_run_of_the_harness_loads_no_jax():
    """Import the harness, the drivers and the port's modules the drivers
    use in a fresh interpreter: none of the forbidden names is loaded."""
    code = (
        "import sys; sys.path.insert(0, '.');"
        "from dcbench import harness, program, compare, trace;"
        "program.port();"
        "[harness.load_cell(w['name']) for w in "
        "harness.manifest()['workloads']];"
        "print(','.join(harness.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_no_card_no_result(tmp_path):
    """Without a CUDA device (this machine) the command exits non-zero
    and prints nothing on standard output."""
    out = subprocess.run(
        [sys.executable, "dcbench/run.py", "--workload", "sim100-burst",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=BENCH.parent, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_without_the_port_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files, the command exits non-zero and prints no result."""
    import shutil
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "dcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "dcbench/run.py", "--workload",
         "sweep-paper-policies", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "cannot be imported" in out.stderr
