"""Mid-run checkpoint and resume in the port, and across the two packages.

A port run stopped at a mid-run step and resumed gives the trace, curves
and params of the uninterrupted port run: the sync synthetic trainer
(engine kind ``sync_fed``), the async engine on ``serial`` and ``vmap``,
with ``ucb_bandit`` and ``periodic_auction``, under the adaptive buffer
controllers, and the ``arch`` LM engines in both modes. The layout is the
reference's, so a step written by the reference resumes in the port and a
step written by the port resumes in the reference: both continue with the
allocation or event trace of the reference's uninterrupted run, params
within 1e-4 and LM losses within 1e-5. The reference's own
embedded-history fixture resumes in the port as it does in the reference.
"""
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro_torch.interop import params_to_numpy

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "legacy_ckpt_async"
TRACE = ("time", "versions", "arrivals", "buffer_sizes", "staleness_mean", "dropped",
         "cost_dropouts")



@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a shared CPU, where each process's full thread pool
    oversubscribes the cores and these small runs spin rather than
    compute."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(api, spec):
    return api.run_scenario(spec, device="cpu") if api is tapi else api.run_scenario(spec)


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in _leaves_raw(tree)]


def _params_close(a, b, atol):
    """Final params of two RunResults (tensor or jax leaves) within atol."""
    for la, lb in zip(_leaves(params_to_numpy(a.params) if _is_torch(a) else a.params),
                      _leaves(params_to_numpy(b.params) if _is_torch(b) else b.params)):
        np.testing.assert_allclose(la, lb, atol=atol, rtol=0)


def _is_torch(res):
    return isinstance(_leaves_raw(res.params)[0], torch.Tensor)


def _leaves_raw(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_raw(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves_raw(v)]
    return [tree]


def _same_async(a, b, exact=True):
    for key in TRACE:
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key), err_msg=key)
    assert a.assignments == b.assignments
    if exact:
        np.testing.assert_array_equal(a.loss, b.loss)
        np.testing.assert_array_equal(a.acc, b.acc)


def _same_sync(a, b, exact=True):
    for key in ("alloc", "alloc_counts", "wall_clock_sim"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key), err_msg=key)
    if exact:
        np.testing.assert_array_equal(a.loss, b.loss)
        np.testing.assert_array_equal(a.acc, b.acc)


def _same(a, b, exact=True):
    (_same_sync if a.mode == "sync" else _same_async)(a, b, exact)


def _async_spec(api, ckpt_dir=None, every=4, resume=False, backend="serial", policy=None,
                auction=None, controller=None, controller_options=None, aggregator=None,
                total_arrivals=36):
    return api.ScenarioSpec(
        name="resume", seed=0,
        tasks=[api.TaskSpec("synth-mnist", options={"n_range": [40, 60]}),
               api.TaskSpec("synth-fmnist", options={"n_range": [40, 60]})],
        clients=api.ClientPopulationSpec(n_clients=10, speed_profile="bimodal",
                                         speed_spread=4.0),
        policy=policy, auction=auction,
        runtime=api.RuntimeSpec(mode="async", backend=backend, tau=2,
                                total_arrivals=total_arrivals, buffer_size=3,
                                buffer_controller=controller,
                                buffer_controller_options=dict(controller_options or {}),
                                aggregator=aggregator,
                                aggregator_options={"lr": 0.1} if aggregator else {},
                                checkpoint_dir=ckpt_dir, checkpoint_every=every,
                                resume=resume))


def _sync_fed_spec(api, ckpt_dir=None, resume=False, aggregator=None, cost_model=None):
    return api.ScenarioSpec(
        name="resume-sync", seed=0,
        tasks=[api.TaskSpec("synth-mnist", options={"n_range": [30, 40]}),
               api.TaskSpec("synth-fmnist", options={"n_range": [30, 40]})],
        clients=api.ClientPopulationSpec(n_clients=8, participation=0.5),
        runtime=api.RuntimeSpec(mode="sync", rounds=6, tau=2, aggregator=aggregator,
                                aggregator_options={"lr": 0.1} if aggregator else {},
                                cost_model=cost_model, checkpoint_dir=ckpt_dir,
                                checkpoint_every=2, resume=resume))


def _arch_spec(api, mode, ckpt_dir=None, resume=False):
    return api.ScenarioSpec(
        name=f"arch-{mode}-resume",
        tasks=[api.TaskSpec("smollm-135m", family="arch",
                            options={"preset": "tiny", "seq": 16, "batch": 2, "tau": 2}),
               api.TaskSpec("qwen3-0.6b", family="arch",
                            options={"preset": "tiny", "seq": 16, "batch": 2, "tau": 1})],
        clients=api.ClientPopulationSpec(n_clients=4, speed_profile="bimodal"),
        runtime=api.RuntimeSpec(mode=mode, rounds=3, total_arrivals=12, buffer_size=2, tau=2,
                                checkpoint_dir=ckpt_dir, checkpoint_every=2, resume=resume))


def _stop_mid_run(d):
    """Leave the directory as a run stopped after its first complete step:
    drop the later steps (the sidecar past the kept step's offset is
    truncated by ``begin``)."""
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    for x in steps[1:]:
        shutil.rmtree(os.path.join(d, x))
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write(str(int(steps[0][5:])))
    return int(steps[0][5:])


# ----------------------------------------------------- port resumes port

CASES = {
    "sync_fed": lambda d=None, r=False: _sync_fed_spec(tapi, d, r),
    "sync_fed-fedadam-tiers": lambda d=None, r=False: _sync_fed_spec(
        tapi, d, r, aggregator="fedadam", cost_model="device_tiers"),
    "async-serial": lambda d=None, r=False: _async_spec(tapi, d, resume=r),
    "async-vmap-fedadam": lambda d=None, r=False: _async_spec(
        tapi, d, resume=r, backend="vmap", aggregator="fedadam"),
    "async-ucb-periodic": lambda d=None, r=False: _async_spec(
        tapi, d, resume=r, policy=tapi.PolicySpec("ucb_bandit", {"epsilon": 0.3}),
        auction=tapi.AuctionSpec(mechanism="gmmfair", budget=8.0, bid_seed=0,
                                 incentive="periodic_auction", incentive_options={"every": 3})),
    "async-staleness_target": lambda d=None, r=False: _async_spec(
        tapi, d, resume=r, controller="staleness_target",
        controller_options={"target": 0.5, "min_size": 2}),
    "async-arrival_rate": lambda d=None, r=False: _async_spec(
        tapi, d, resume=r, controller="arrival_rate",
        controller_options={"min_size": 2, "max_size": 8}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_resume_matches_uninterrupted(case, tmp_path):
    """Checkpointing changes nothing, and the run resumed from a mid-run
    step equals the uninterrupted one bit for bit (traces, curves,
    params, the incentive's ledger)."""
    make = CASES[case]
    d = str(tmp_path / "ck")
    full = _run(tapi, make())
    ck = _run(tapi, make(d))
    _same(full, ck)
    _stop_mid_run(d)
    resumed = _run(tapi, make(d, True))
    _same(full, resumed)
    _params_close(full, resumed, 0.0)
    assert full.auction == resumed.auction


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_arch_resume_matches_uninterrupted(mode, tmp_path):
    """The arch LM engines (sync: params, AdamW state and the fold's
    aggregator; async: the arch adapters) resume through the same path."""
    d = str(tmp_path / "ck")
    full = _run(tapi, _arch_spec(tapi, mode))
    _run(tapi, _arch_spec(tapi, mode, d))
    _stop_mid_run(d)
    resumed = _run(tapi, _arch_spec(tapi, mode, d, True))
    _same(full, resumed)
    _params_close(full, resumed, 0.0)


def test_async_state_dict_json_roundtrip_continues_exactly():
    """Without disk: a mid-run engine's state and history through real JSON
    text into a fresh engine continue with the same events."""
    fam = tapi.TASK_FAMILIES.get("synthetic")()
    full = fam.async_engine(_async_spec(tapi, total_arrivals=18), device="cpu").run()
    half = fam.async_engine(_async_spec(tapi, total_arrivals=18), device="cpu")
    half.engine.cfg.total_arrivals = 9
    half.run()
    state = json.loads(json.dumps(half.engine.state_dict()))
    assert "history" not in state and "assignments" not in state
    records = json.loads(json.dumps(half.engine.history_records()))
    trees = {t.name: {"params": half.engine._params[s],
                      "retained": {str(v): slot[0] for v, slot in
                                   half.engine._retained[s].items()}}
             for s, t in enumerate(half.engine.tasks)}
    rest = fam.async_engine(_async_spec(tapi, total_arrivals=18), device="cpu")
    rest.engine.load_state(state, trees, history=records)
    resumed = rest.run()
    np.testing.assert_array_equal(full.loss, resumed.loss)
    np.testing.assert_array_equal(full.time, resumed.time)
    assert full.assignments == resumed.assignments


def test_sync_resume_from_async_checkpoint_raises(tmp_path):
    d = str(tmp_path / "ck")
    _run(tapi, _async_spec(tapi, d, every=2, total_arrivals=12))
    with pytest.raises(ValueError, match="written by the async engine"):
        _run(tapi, _sync_fed_spec(tapi, d, resume=True))


# --------------------------------------------------- across the packages

XCASES = {
    "sync_fed-fedadam": (lambda api, d=None, r=False: _sync_fed_spec(api, d, r,
                                                                     aggregator="fedadam")),
    "async-fedadam": (lambda api, d=None, r=False: _async_spec(api, d, resume=r,
                                                               aggregator="fedadam")),
    "async-ucb-periodic": (lambda api, d=None, r=False: _async_spec(
        api, d, resume=r, policy=api.PolicySpec("ucb_bandit", {"epsilon": 0.3}),
        auction=api.AuctionSpec(mechanism="gmmfair", budget=8.0, bid_seed=0,
                                incentive="periodic_auction", incentive_options={"every": 3}))),
}


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("case", sorted(XCASES))
def test_cross_package_resume(case, writer, tmp_path):
    """A mid-run step written by one package resumes in the other; the
    resumed run has the trace of the reference's uninterrupted run,
    accuracies within 1e-3 and params within 1e-4."""
    make = XCASES[case]
    first, second = (japi, tapi) if writer == "reference" else (tapi, japi)
    d = str(tmp_path / "ck")
    full = _run(japi, make(japi))
    _run(first, make(first, d))
    _stop_mid_run(d)
    resumed = _run(second, make(second, d, True))
    _same(resumed, full, exact=False)
    np.testing.assert_allclose(resumed.acc, full.acc, atol=1e-3, rtol=0)
    _params_close(resumed, full, 1e-4)
    assert resumed.auction == full.auction


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_cross_package_arch_resume(mode, writer, tmp_path):
    """The LM engines across the packages: params, AdamW state (its int32
    count) and the sidecar written by one resume in the other; identical
    traces and losses within 1e-5 of the reference's uninterrupted run."""
    first, second = (japi, tapi) if writer == "reference" else (tapi, japi)
    d = str(tmp_path / "ck")
    full = _run(japi, _arch_spec(japi, mode))
    _run(first, _arch_spec(first, mode, d))
    _stop_mid_run(d)
    resumed = _run(second, _arch_spec(second, mode, d, True))
    _same(resumed, full, exact=False)
    np.testing.assert_allclose(resumed.loss, full.loss, atol=1e-5, rtol=0)


def test_legacy_embedded_history_fixture_resumes_as_in_reference(tmp_path):
    """The reference's committed embedded-history async step
    (tests/fixtures/legacy_ckpt_async) resumes in the port as it does in
    the reference, in this process: identical event traces and the whole
    run's curves, accuracies within 1e-3, params within 1e-4; the port
    backfills the sidecar and stamps its new steps."""
    doc = (FIXTURE / "spec.json").read_text()
    results = {}
    for name, api in (("reference", japi), ("port", tapi)):
        d = str(tmp_path / name)
        shutil.copytree(FIXTURE / "ckpt", d)
        spec = api.ScenarioSpec.from_json(doc.replace("__CKPT__", d))
        spec.runtime.checkpoint_every = 1
        results[name] = (_run(api, spec), d)
    (rt, dt), (rj, _) = results["port"], results["reference"]
    _same_async(rt, rj, exact=False)
    np.testing.assert_allclose(rt.acc, rj.acc, atol=1e-3, rtol=0)
    np.testing.assert_allclose(rt.loss, rj.loss, atol=1e-3, rtol=0)
    _params_close(rt, rj, 1e-4)
    meta = json.load(open(f"{dt}/step_{int(open(f'{dt}/LATEST').read()):08d}/STEP.json"))
    assert meta["engine"] == "async"
    assert 0 < meta["history_offset"] <= os.path.getsize(f"{dt}/history.jsonl")
    spec = tapi.ScenarioSpec.from_json(doc.replace("__CKPT__", dt))
    spec.runtime.checkpoint_every = 1
    _same_async(_run(tapi, spec), rt)


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the GPU machine")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fedadam_moments_restored_onto_the_card_feed_fused_aggregate(cuda_device, tmp_path):
    """A fedadam step written on the CPU resumes on the card: the params
    and server moments land on the card, the first flush after the resume
    launches fused_aggregate, and the events equal the CPU's own resume."""
    from repro_torch.kernels import LAUNCHES, reset_launches

    d = str(tmp_path / "ck")
    spec = _async_spec(tapi, d, aggregator="fedadam", backend="vmap")
    tapi.run_scenario(spec, device="cpu")
    step = _stop_mid_run(d)
    cpu_dir = str(tmp_path / "cpu")
    shutil.copytree(d, cpu_dir)
    cpu = tapi.run_scenario(_async_spec(tapi, cpu_dir, aggregator="fedadam", backend="vmap",
                                        resume=True), device="cpu")
    runner = tapi.TASK_FAMILIES.get("synthetic")().async_engine(
        _async_spec(tapi, d, aggregator="fedadam", backend="vmap", resume=True), device="cuda")
    reset_launches()
    h = runner.engine.run()
    torch.cuda.synchronize()
    flushes_after = len(h.time) - step
    assert flushes_after > 0 and LAUNCHES["fused_aggregate"] == flushes_after
    assert {leaf.device.type for tree in (runner.engine._params, runner.engine._server_state)
            for leaf in _leaves_raw(tree)} == {"cuda"}
    np.testing.assert_array_equal(h.time, cpu.time)
    assert h.assignments == cpu.assignments
