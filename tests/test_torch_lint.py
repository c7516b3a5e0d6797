"""The repository's linter (``tools/lint.py``, whose ``TARGETS`` cover the
JAX side) over the port: every module of ``steroscopic_hardware_tpu_torch``,
``chip_smoke.py``, every ``tests/test_torch_*.py`` and their
``tests/torch_wait.py`` (syntax, unused imports, tabs, trailing
whitespace, the final newline, lines over 100 columns, star imports), in
one case that reports every problem together."""

import importlib.util
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("lint",
                                               ROOT / "tools" / "lint.py")
lint = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(lint)

FILES = sorted(
    [*(ROOT / "steroscopic_hardware_tpu_torch").rglob("*.py"),
     ROOT / "chip_smoke.py",
     *(ROOT / "tests").glob("test_torch_*.py"),
     ROOT / "tests" / "torch_wait.py"])


def test_the_port_has_files_to_lint():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"chip_smoke.py", "steroscopic_hardware_tpu_torch/soak.py",
            "steroscopic_hardware_tpu_torch/utils/timing.py",
            "tests/test_torch_lint.py"} <= names
    assert len(FILES) > 90


def test_lint_clean():
    before = len(lint.PROBLEMS)
    for path in FILES:
        lint.lint_file(path)
    found = lint.PROBLEMS[before:]
    del lint.PROBLEMS[before:]
    assert not found, "\n".join(found)
