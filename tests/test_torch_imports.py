"""The port stands alone: nothing under src/repro_torch, and none of
chip_smoke.py, profile_async.py, profile_kernels.py and profile_lm.py,
imports jax or the JAX package."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "profile_async.py", ROOT / "profile_kernels.py",
    ROOT / "profile_lm.py"]
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


LM_SLICE = ["configs/__init__.py", "configs/base.py", "configs/smollm_135m.py",
            "configs/qwen3_0_6b.py", "configs/qwen1_5_0_5b.py", "configs/qwen1_5_110b.py",
            "kernels/flash_attention.py", "kernels/rmsnorm.py", "models/__init__.py",
            "models/layers.py", "models/attention.py", "models/transformer.py",
            "models/model.py", "launch/__init__.py", "launch/serve.py",
            "configs/zamba2_7b.py", "kernels/gated_rmsnorm.py", "kernels/ssd_scan.py",
            "models/ssm.py", "models/hybrid.py"]


@pytest.mark.parametrize("rel", LM_SLICE)
def test_lm_slice_modules_are_checked(rel):
    assert ROOT / "src" / "repro_torch" / rel in FILES


INCENTIVE_SLICE = ["core/auctions.py", "core/theory.py", "api/sweep.py", "api/policy.py",
                   "api/costmodel.py", "api/aggregator.py", "api/registry.py"]


@pytest.mark.parametrize("rel", INCENTIVE_SLICE)
def test_incentive_slice_modules_are_checked(rel):
    assert ROOT / "src" / "repro_torch" / rel in FILES


TRAIN_SLICE = ["optim/__init__.py", "optim/optim.py", "launch/train.py", "api/engine.py",
               "fed/async_engine.py", "interop.py", "tree.py"]


@pytest.mark.parametrize("rel", TRAIN_SLICE)
def test_train_slice_modules_are_checked(rel):
    assert ROOT / "src" / "repro_torch" / rel in FILES


MESH_SLICE = ["launch/mesh.py", "sharding/__init__.py", "sharding/partition.py",
              "api/backend.py"]


@pytest.mark.parametrize("rel", MESH_SLICE)
def test_mesh_slice_modules_are_checked(rel):
    assert ROOT / "src" / "repro_torch" / rel in FILES


def test_importing_every_port_module_loads_no_jax():
    """Import every module of the port in a fresh interpreter, then look at
    what was loaded: neither jax nor the JAX package."""
    pkg = ROOT / "src" / "repro_torch"
    mods = sorted(".".join(("repro_torch",) + p.relative_to(pkg).with_suffix("").parts)
                  .removesuffix(".__init__") for p in pkg.rglob("*.py"))
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         timeout=120)
    assert out.returncode == 0, out.stderr


POPULATION_CHECKPOINT_SLICE = ["checkpoint/__init__.py", "checkpoint/checkpoint.py",
                               "pop/__init__.py", "pop/data.py", "pop/population.py",
                               "api/arrivals.py", "api/buffer.py", "fed/trainer.py"]


@pytest.mark.parametrize("rel", POPULATION_CHECKPOINT_SLICE)
def test_population_checkpoint_slice_modules_are_checked(rel):
    assert ROOT / "src" / "repro_torch" / rel in FILES


FAMILIES_SLICE = ["configs/qwen2_moe_a2_7b.py", "configs/xlstm_1_3b.py", "models/moe.py",
                  "models/xlstm.py", "models/xlstm_lm.py", "prng.py"]


@pytest.mark.parametrize("rel", FAMILIES_SLICE)
def test_families_slice_modules_are_checked(rel):
    assert ROOT / "src" / "repro_torch" / rel in FILES


VLM_QUEUE_SLICE = ["configs/phi3_vision_4_2b.py", "launch/queue.py"]


@pytest.mark.parametrize("rel", VLM_QUEUE_SLICE)
def test_vlm_queue_slice_modules_are_checked(rel):
    assert ROOT / "src" / "repro_torch" / rel in FILES


ANALYSIS_SLICE = ["analysis/__init__.py", "analysis/framework.py", "analysis/rules.py",
                  "analysis/__main__.py"]


@pytest.mark.parametrize("rel", ANALYSIS_SLICE)
def test_analysis_slice_modules_are_checked(rel):
    assert ROOT / "src" / "repro_torch" / rel in FILES


@pytest.mark.parametrize("mod", ["repro_torch.core.allocation", "repro_torch.core.theory",
                                 "repro_torch.core.mmfl"])
def test_core_module_imports_first(mod):
    """Each of these imports first in a fresh interpreter, as its JAX
    package counterpart does: ``api.policy`` and ``pop.data`` import
    ``core``/``fed`` when they run, not at module level."""
    out = subprocess.run([sys.executable, "-c", f"import {mod}"], cwd=ROOT, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         timeout=120)
    assert out.returncode == 0, out.stderr
