"""The heavy-tailed and replayed cost models, bit for bit against the JAX
package.

``lognormal_straggler`` and ``trace_replay`` get the same seeded
generator in both packages; every sampled latency and dropout flag must
be identical, and so must the generator's state afterwards. The trace
validator must refuse each malformed trace with the reference's message.
"""
import json

import numpy as np
import pytest

from repro.api import costmodel as j_cost
from repro_torch.api import costmodel as t_cost

TRACE = {"latencies": {"0": [1.5, 0.5, 2.0], "3": [0.25], "*": [1.0, 3.0]}}


def _samples(mod, name, options, n_clients=12, n_tasks=3, task_sizes=(1738.0, 6922.0, 3786.0),
             steps=300, seed=5):
    model = mod.get_cost_model(name, options)
    rng = np.random.default_rng(seed)
    model.reset(n_clients, n_tasks, rng, task_sizes=task_sizes)
    pick = np.random.default_rng(seed + 1)
    out = []
    for i in range(steps):
        client, task = int(pick.integers(n_clients)), int(pick.integers(n_tasks))
        lat = model.sample_latency(client, task, float(pick.uniform(0.25, 4.0)),
                                   time=float(i), version=i // 7)
        out.append((lat.compute, lat.comm, lat.dropout, lat.total))
    return out, rng.bit_generator.state, model


@pytest.mark.parametrize("options", [
    {},
    {"sigma": 0.6, "straggler_frac": 0.25, "straggler_factor": 4.0, "dropout_prob": 0.05},
    {"sigma": 0.0, "straggler_frac": 1.0, "straggler_factor": 1.0, "dropout_prob": 1.0},
    {"sigma": 1.5, "straggler_frac": 0.0, "dropout_prob": 0.3},
])
def test_lognormal_straggler_matches_reference(options):
    got, got_rng, tm = _samples(t_cost, "lognormal_straggler", options)
    want, want_rng, jm = _samples(j_cost, "lognormal_straggler", options)
    assert got == want
    assert got_rng == want_rng
    np.testing.assert_array_equal(tm._straggler, jm._straggler)
    if options.get("dropout_prob", 0.0) > 0:
        assert any(d for _, _, d, _ in got)


@pytest.mark.parametrize("options", [
    {"trace": TRACE},
    {"trace": TRACE, "scale": 0.5},
    {"trace": {"latencies": {str(c): [0.5 + c, 1.0] for c in range(12)}}},
])
@pytest.mark.parametrize("task_sizes", [(1738.0, 6922.0, 3786.0), None, (0.0, 1.0, 2.0)])
def test_trace_replay_matches_reference(options, task_sizes):
    got, got_rng, _ = _samples(t_cost, "trace_replay", options, task_sizes=task_sizes)
    want, want_rng, _ = _samples(j_cost, "trace_replay", options, task_sizes=task_sizes)
    assert got == want
    assert got_rng == want_rng


def test_trace_replay_reads_a_file(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(TRACE))
    got, _, _ = _samples(t_cost, "trace_replay", {"path": str(path)})
    want, _, _ = _samples(j_cost, "trace_replay", {"trace": TRACE})
    assert got == want


def test_trace_replay_cursors_restart_at_reset():
    model = t_cost.get_cost_model("trace_replay", {"trace": TRACE})
    model.reset(4, 1, np.random.default_rng(0))
    first = [model.sample_latency(0, 0, 1.0).compute for _ in range(4)]
    model.reset(4, 1, np.random.default_rng(0))
    assert [model.sample_latency(0, 0, 1.0).compute for _ in range(4)] == first
    assert first == [1.5, 0.5, 2.0, 1.5]


@pytest.mark.parametrize("kwargs", [
    {},
    {"path": "x.json", "trace": TRACE},
    {"trace": [1.0, 2.0]},
    {"trace": {"lat": {}}},
    {"trace": {"latencies": {}}},
    {"trace": {"latencies": [1.0]}},
    {"trace": {"latencies": {"a": [1.0]}}},
    {"trace": {"latencies": {"0": []}}},
    {"trace": {"latencies": {"0": 1.0}}},
    {"trace": {"latencies": {"0": [1.0, 0.0]}}},
    {"trace": {"latencies": {"0": [1.0, -2.0]}}},
    {"trace": {"latencies": {"0": [True]}}},
    {"trace": {"latencies": {"0": ["1.0"]}}},
    {"trace": {"latencies": {"0": [float("nan")]}}},
    {"trace": {"latencies": {"0": [float("inf")]}}},
    {"trace": TRACE, "scale": 0.0},
], ids=lambda kw: str(kw)[:40])
def test_trace_errors_match_reference(kwargs):
    with pytest.raises(ValueError) as ej:
        j_cost.TraceReplay(**kwargs)
    with pytest.raises(ValueError) as et:
        t_cost.TraceReplay(**kwargs)
    assert str(et.value) == str(ej.value)


def test_trace_file_errors_match_reference(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    for path in (str(tmp_path / "missing.json"), str(bad)):
        with pytest.raises(ValueError) as ej:
            j_cost.TraceReplay(path=path)
        with pytest.raises(ValueError) as et:
            t_cost.TraceReplay(path=path)
        assert str(et.value) == str(ej.value)


def test_trace_without_fallback_refuses_missing_clients():
    trace = {"latencies": {"0": [1.0], "2": [2.0]}}
    for mod in (j_cost, t_cost):
        model = mod.TraceReplay(trace=trace)
        with pytest.raises(ValueError, match=r"no latency sequence for clients \[1, 3\]"):
            model.reset(4, 1, np.random.default_rng(0))


@pytest.mark.parametrize("options", [
    {"sigma": -0.1}, {"straggler_frac": 1.5}, {"straggler_factor": 0.5},
    {"dropout_prob": -0.1}, {"mu": 1.0},
])
def test_lognormal_option_errors_match_reference(options):
    with pytest.raises(ValueError) as ej:
        j_cost.get_cost_model("lognormal_straggler", options)
    with pytest.raises(ValueError) as et:
        t_cost.get_cost_model("lognormal_straggler", options)
    assert str(et.value) == str(ej.value)


def test_cost_model_registry_keys_are_the_same_set():
    from repro.api.registry import COST_MODELS as J
    from repro_torch.api.registry import COST_MODELS as T

    assert set(T.names()) == set(J.names())
