"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port: checked by the modules a fresh
process holds after importing them (top-level names compared whole), and
by the import statements of every file under ``perfbench/``."""

import ast
import subprocess
import sys

import pytest

from perfbench.tests.conftest import ROOT

JAX = {"jax", "jaxlib", "flax", "repro"}
HARNESS = ("perfbench.run", "perfbench.control", "perfbench.harness.session",
           "perfbench.harness.trace", "perfbench.harness.check", "repro_torch.api.engine",
           "repro_torch.launch.train")
REFERENCE = ("perfbench.reference.mmfl", "perfbench.reference.vlm",
             "perfbench.reference.moe", "perfbench.reference.audio")


def _loaded(modules) -> set:
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            + "".join(f"import {m}\n" for m in modules)
            + "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    return set(out.stdout.split())


def test_the_harness_loads_no_jax():
    assert not _loaded(HARNESS) & JAX


def test_the_reference_loads_neither_jax_nor_the_port():
    assert not _loaded(REFERENCE) & (JAX | {"repro_torch"})


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    assert not names & JAX
    if "reference" in path.parts:
        assert "repro_torch" not in names
