"""A cell of the benchmark: its workload file (the traffic mix) and the
configuration file it names, both found by name under ``perfbench/``.

``perfbench/workloads/<cell>.json``: ``config``, ``traffic``, the
scenario (clients, participation, alpha, strategy, backend, aggregator),
each task's traffic (``arch``, ``tau``, ``batch``, ``seq``, ``shards``),
``warm_rounds`` and the ``limits`` of the numbers compared.
``perfbench/configs/<config>.json``: each task's model as it is run
(``tasks[i].model``, the port's config fields), its source and cut.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

from perfbench.reference.common import ModelConfig

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict

    @property
    def scenario(self) -> dict:
        return self.workload["scenario"]

    @property
    def warm_rounds(self) -> int:
        return self.workload["warm_rounds"]

    @property
    def limits(self) -> dict:
        return self.workload["limits"]

    def tasks(self) -> list:
        """Each task's traffic, with ``cfg``: its model as a reference
        ``ModelConfig``; in the workload's order."""
        models = {t["arch"]: t for t in self.config["tasks"]}
        return [dict(t, cfg=ModelConfig.from_dict(models[t["arch"]]["model"]))
                for t in self.workload["tasks"]]


def load(name: str) -> Cell:
    workload = json.loads((ROOT / "workloads" / f"{name}.json").read_text())
    config = json.loads((ROOT / "configs" / f"{workload['config']}.json").read_text())
    return Cell(name, workload, config)


class DepthCut:
    """Builds the named archs at fewer layers, their widths unchanged: a
    pass-through around ``launch.train.get_config``. Layer i of a cut
    model is layer i of the full one, so the cut is the first layers of
    the same model."""

    def __init__(self, layers: dict):
        self.layers = layers

    def __enter__(self):
        import repro_torch.launch.train as train

        self._saved = get_config = train.get_config

        def cut(name):
            cfg = get_config(name)
            return cfg.replace(n_layers=self.layers[name]) if name in self.layers else cfg

        train.get_config = cut
        return self

    def __exit__(self, *exc):
        import repro_torch.launch.train as train

        train.get_config = self._saved
