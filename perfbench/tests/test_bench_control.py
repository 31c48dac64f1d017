"""The control on the card at the smoke size: the reference computed with
TF32 on, put in the program's place, fails the cell's limits; the f32
reference run twice passes them. The readings at each cell's own size
come from ``perfbench/control.py``."""

import pytest
import torch

from perfbench.tests.conftest import BENCH, tiny_cell

CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_is_not_correct(card, name):
    from perfbench.harness import check
    from perfbench.reference import mmfl

    cell = tiny_cell(name)
    tasks = cell.tasks()
    ref = mmfl.follow(tasks, cell.scenario, 424242, card, cell.warm_rounds)
    again = mmfl.follow(tasks, cell.scenario, 424242, card, cell.warm_rounds)
    tf32 = mmfl.follow(tasks, cell.scenario, 424242, card, cell.warm_rounds, tf32=True)
    assert check.verdict(check.compare(check.as_program(again, tasks), ref, tasks), cell.limits)
    assert not check.verdict(check.compare(check.as_program(tf32, tasks), ref, tasks),
                             cell.limits)
