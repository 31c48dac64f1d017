"""Tiny cells for the benchmark's CPU tests: a workload file's traffic
with the smoke configs of its archs (2 layers, d_model 128), 4 rows of 32
tokens and 16 shards a client."""

import dataclasses
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SEQ = 32
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_cell(name: str):
    """``name``'s cell with its models at the smoke size and its limits."""
    from repro_torch.configs import smoke_config

    from perfbench.harness.cell import Cell, load

    cell = load(name)
    tasks = [dict(t, batch=4, seq=SEQ, shards=16, preset="tiny") for t in cell.workload["tasks"]]
    models = []
    for t in tasks:
        c = smoke_config(t["arch"])
        c = c.replace(ssm_chunk=min(c.ssm_chunk, max(8, SEQ // 4)))
        models.append({"arch": t["arch"], "model": dataclasses.asdict(c)})
    return Cell(f"{name}.tiny", dict(cell.workload, tasks=tasks), dict(cell.config, tasks=models))


@pytest.fixture(autouse=True)
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
