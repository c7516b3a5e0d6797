"""Nothing the benchmark runs imports JAX, the JAX package, the repo's
``tools/`` or root ``bench.py``; the reference imports nothing of the
program. Top-level module names are compared whole: the port's name
begins with the JAX package's."""

import ast
import os
import subprocess
import sys

from benchmark import run

FORBIDDEN = {"jax", "jaxlib", "flax", "steroscopic_hardware_tpu", "tools",
             "bench"}
PORT = "steroscopic_hardware_tpu_torch"


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    top = os.path.join(run.BENCH_DIR, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_a_forbidden_module():
    for path in sources():
        assert not top_level_imports(path) & FORBIDDEN, path


def test_whole_names_are_compared():
    assert PORT.startswith("steroscopic_hardware_tpu")
    assert PORT not in FORBIDDEN
    assert run.forbidden_modules() == [] or "jax" in sys.modules


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert PORT not in top_level_imports(path), path


def test_a_run_loads_no_forbidden_module(tmp_path):
    code = (
        "import sys, time\n"
        "from benchmark.tests.tiny import tiny_checkout\n"
        "from benchmark import run\n"
        f"spec = tiny_checkout({str(tmp_path)!r})\n"
        "line = run.run_cell(spec, 'tiny.cam', 5, 1.0, False, device='cpu',"
        f" bench_dir={str(tmp_path / 'benchmark')!r}, root={str(tmp_path)!r},"
        " t_start=time.perf_counter())\n"
        "bad = {m.split('.')[0] for m in sys.modules} & %r\n"
        "print('BAD', sorted(bad))\n" % FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout
