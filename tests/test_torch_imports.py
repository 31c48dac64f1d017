"""The port stands alone: nothing under src/repro_torch, and neither
chip_smoke.py nor profile_async.py, imports jax or the JAX package."""
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                ROOT / "profile_async.py"]
IMPORT = re.compile(r"^\s*(import|from)\s+(jax|repro)\b(?!_torch)", re.M)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    assert path.exists()
    hits = [m.group(0) for m in IMPORT.finditer(path.read_text())]
    assert hits == []


def test_regex_catches_reference_imports():
    for bad in ["import jax", "from jax import numpy", "  import repro.api",
                "from repro.fed import data", "import repro"]:
        assert IMPORT.search(bad), bad
    for ok in ["import repro_torch", "from repro_torch.api import spec", "import jaxlib_x"]:
        assert not IMPORT.search(ok), ok
