"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port; top-level names compared whole."""

import ast
import pathlib
import subprocess
import sys

from benchmark import run

from small import ROOT

BENCH = ROOT / "benchmark"


def top_level_imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "jpeggpu_tpu_torch_fake", object())
    assert "jpeggpu_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jpeggpu_tpu.fake", object())
    assert run.forbidden_modules() == ["jpeggpu_tpu"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        names = set(top_level_imports(path))
        assert not names & set(run.FORBIDDEN), path


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        names = set(top_level_imports(path))
        assert not names & {"jpeggpu_tpu_torch", "torch", "jax",
                            "jpeggpu_tpu"}, path


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time, torch\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from benchmark import run\n"
        "from small import small_params\n"
        "r, _ = run.run_cell('imagenet_loader.b32', 3, 0.2, False,\n"
        "    torch.device('cpu'), start=time.perf_counter(),\n"
        "    params=small_params('imagenet_loader.b32'), workers=1)\n"
        "assert r['correct']\n"
        "import benchmark.reference.parallel\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "jpeggpu_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN)


def test_reference_alone_loads_numpy_only():
    code = ("import sys\n"
            "import benchmark.reference.parallel\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not loaded & {"torch", "jpeggpu_tpu_torch", "jax", "jpeggpu_tpu"}
