"""A run of each cell's traffic at the smoke size on the CPU, with the
timed path broken underneath, comes out not correct: the harness's look
for a card skipped, the rest of the run as the benchmark drives it."""

import contextlib
import dataclasses

import pytest
import torch

from perfbench.tests.conftest import BENCH, tiny_cell

CELLS = [w["name"] for w in BENCH["workloads"]]


def _stack_like(old, new):
    if isinstance(new, dict):
        return {k: _stack_like(old[k], new[k]) for k in new}
    if isinstance(new, (tuple, list)):
        return type(new)(_stack_like(o, n) for o, n in zip(old, new))
    return old[None].expand(new.shape).clone()


@contextlib.contextmanager
def unchanged_state():
    """Every cohort returns its state as it came: params (and AdamW state)."""
    from repro_torch.api import backend

    run = backend.VmapBackend.run_cohort

    def broken(self, task_state, client_batch, rng=None):
        res = run(self, task_state, client_batch, rng)
        return backend.CohortResult(_stack_like(task_state.params, res.updates), res.losses)

    backend.VmapBackend.run_cohort = broken
    try:
        yield
    finally:
        backend.VmapBackend.run_cohort = run


@contextlib.contextmanager
def half_batch():
    """Each round's batch keeps its first half, the weights renormalised."""
    from repro_torch.api import engine

    assemble = engine.assemble_batch

    def broken(task, data, ids, w, rng):
        batch = assemble(task, data, ids, w, rng)
        n = batch["client_weights"].shape[0] // 2
        out = {k: v[:n] for k, v in batch.items()}
        out["client_weights"] = out["client_weights"] / out["client_weights"].sum()
        return out

    engine.assemble_batch = broken
    try:
        yield
    finally:
        engine.assemble_batch = assemble


@contextlib.contextmanager
def altered_answer():
    """The probe's first token of row 0 pushed below every other, where the
    model's prefill produces it."""
    from repro_torch.models import model

    saved = dict(model._APIS)

    def alter(prefill):
        def broken(params, cfg, batch):
            logits, caches = prefill(params, cfg, batch)
            logits = logits.clone()
            row = logits[0, -1]
            row[row.argmax()] = row.min() - 1
            return logits, caches

        return broken

    for k, api in saved.items():
        model._APIS[k] = dataclasses.replace(api, prefill_fn=alter(api.prefill_fn))
    try:
        yield
    finally:
        model._APIS.update(saved)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_run_is_not_correct(name, fault):
    from perfbench.run import run_cell

    with FAULTS[fault]():
        out = run_cell(tiny_cell(name), 987654321, 0.5, False, torch.device("cpu"))
    assert not out["correct"], out["compared"]
