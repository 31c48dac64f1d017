"""LM training of ``examples/train_concurrent_lms.py``'s mix through both
``run_scenario``s: smollm-135m (dense), xlstm-1.3b (ssm) and
qwen2-moe-a2.7b (moe) as concurrent ``arch`` tasks on the tiny presets.

The same spec goes to the JAX package and to the port. Sync runs (the
fused AdamW step at tau 1; true FedAvg at tau 2 on ``vmap``) and async
runs (fedavg) give identical allocation or event traces, losses within
1e-4, identical accuracy curves and params within 1e-4 (after AdamW's
first step with the share of ill-conditioned elements bounded, as in
tests/test_torch_train.py). The port's train CLI runs the example's mix,
and a run checkpointed and resumed equals the uninterrupted one; a step
the port writes (params and AdamW state of the three trees) resumes in the
reference with the reference's trace and losses within 1e-5.

deepseek-v2-lite-16b (MLA) and whisper-medium (encoder-decoder, its
frames drawn in the batch) as two concurrent ``arch`` tasks on their tiny
presets: loss gradients within 1e-5 x max(1, max|g|) of ``jax.grad``, and
the same three kinds of whole run, held to the same gates.
"""
import functools
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
import repro_torch.launch.train as ttrain
from repro_torch.interop import params_to_numpy

ARCHS = ("smollm-135m", "xlstm-1.3b", "qwen2-moe-a2.7b")
MLA_AUDIO = ("deepseek-v2-lite-16b", "whisper-medium")
RUNS = [dict(), dict(tau=2, backend="vmap"), dict(mode="async")]
RUN_IDS = ["sync_fused_adamw", "sync_tau2_vmap", "async_fedavg"]
EVENTS = ("time", "versions", "arrivals", "buffer_sizes", "staleness_mean", "dropped",
          "cost_dropouts")
ADAM_SHARE = 1e-3           # at most this share of elements beyond 1e-4 (AdamW's first step)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's worker processes share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec(api, *, tau=1, backend="serial", mode="sync", rounds=2, aggregator=None,
          archs=ARCHS):
    return api.ScenarioSpec(
        name="concurrent-lms", seed=0, data_seed=0,
        tasks=[api.TaskSpec(a, family="arch",
                            options={"preset": "tiny", "seq": 32, "batch": 4, "tau": tau})
               for a in archs],
        clients=api.ClientPopulationSpec(n_clients=6, participation=0.5),
        allocation=api.AllocationSpec(strategy="fedfair", alpha=3.0),
        runtime=api.RuntimeSpec(mode=mode, backend=backend, rounds=rounds, tau=tau,
                                total_arrivals=9, buffer_size=3, aggregator=aggregator))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree)}


def _assert_runs_match(rt, rj, max_share=0.0, archs=ARCHS):
    if rt.mode == "sync":
        np.testing.assert_array_equal(rt.alloc, rj.alloc)
        np.testing.assert_array_equal(rt.alloc_counts, rj.alloc_counts)
    else:
        for key in EVENTS:
            np.testing.assert_array_equal(getattr(rt, key), getattr(rj, key), err_msg=key)
        assert rt.assignments == rj.assignments
    np.testing.assert_allclose(rt.loss, rj.loss, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(rt.acc, rj.acc)
    assert rt.task_names == rj.task_names == list(archs)
    beyond, total = 0, 0
    for pt, pj in zip(rt.params, rj.params):
        g, w = _flat(params_to_numpy(pt)), _flat(jax.tree.map(np.asarray, pj))
        assert set(g) == set(w)
        for k in w:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
            if max_share:
                beyond += int((np.abs(g[k] - w[k]) > 1e-4).sum())
                total += w[k].size
            else:
                np.testing.assert_allclose(g[k], w[k], atol=1e-4, rtol=0, err_msg=k)
    assert beyond <= max_share * total, beyond


@functools.lru_cache(maxsize=None)
def _reference_run(**kw):
    return japi.run_scenario(_spec(japi, **kw))


@pytest.mark.parametrize("kw", RUNS, ids=RUN_IDS)
def test_mix_matches_reference(kw):
    rt = tapi.run_scenario(_spec(tapi, **kw), device="cpu")
    rj = _reference_run(**kw)
    assert rt.mode == rj.mode == kw.get("mode", "sync")
    fused_adamw = kw.get("mode", "sync") == "sync" and kw.get("tau", 1) <= 1
    _assert_runs_match(rt, rj, ADAM_SHARE if fused_adamw else 0.0)


@pytest.mark.parametrize("arch", MLA_AUDIO)
def test_mla_and_audio_gradients_match_jax(arch):
    """Loss gradients of the smoke configs, whisper's on nonzero frames."""
    from repro.configs import smoke_config as jax_smoke_config
    from repro.models import get_api as jax_get_api
    from repro_torch.configs import smoke_config
    from repro_torch.interop import lm_params_from_numpy
    from repro_torch.models import get_api
    from repro_torch.tree import tree_map

    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    jparams = jax_get_api(jcfg).init_params(jax.random.PRNGKey(6), jcfg)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(3)
    t = rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    bj = {"tokens": jax.numpy.asarray(t), "labels": jax.numpy.asarray(t)}
    bt = {"tokens": torch.from_numpy(t.astype(np.int64)),
          "labels": torch.from_numpy(t.astype(np.int64))}
    if arch == "whisper-medium":
        f = (0.02 * rng.standard_normal((2, cfg.enc_frames, cfg.d_model))).astype(np.float32)
        bj["frames"], bt["frames"] = jax.numpy.asarray(f), torch.from_numpy(f)
    gj = jax.grad(lambda p: jax_get_api(jcfg).loss_fn(p, jcfg, bj)[0])(jparams)
    params = tree_map(lambda x: x.requires_grad_(True), params)
    loss, _ = get_api(cfg).loss_fn(params, cfg, bt)
    loss.backward()
    got = _flat(tree_map(lambda x: x.grad.numpy(), params))
    want = _flat(jax.tree.map(np.asarray, gj))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-5 * max(1.0, np.abs(w).max()), rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("kw", RUNS, ids=RUN_IDS)
def test_mla_and_audio_runs_match_reference(kw):
    """deepseek-v2-lite and whisper as two tasks: sync (fused AdamW; tau 2
    on vmap) and async runs against the reference's."""
    rt = tapi.run_scenario(_spec(tapi, archs=MLA_AUDIO, **kw), device="cpu")
    rj = _reference_run(archs=MLA_AUDIO, **kw)
    fused_adamw = kw.get("mode", "sync") == "sync" and kw.get("tau", 1) <= 1
    _assert_runs_match(rt, rj, ADAM_SHARE if fused_adamw else 0.0, archs=MLA_AUDIO)


def test_train_cli_runs_the_example_mix(capsys):
    """``examples/train_concurrent_lms.py``'s flags (fewer rounds and
    clients) through the port's CLI on the CPU."""
    res = ttrain.main(["--archs", ",".join(ARCHS), "--preset", "tiny", "--rounds", "3",
                       "--clients", "6", "--seq", "32", "--batch", "4", "--alpha", "3",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "final losses:" in out and all(a in out for a in ARCHS)
    assert res.task_names == list(ARCHS) and res.loss.shape == (3, 3)
    assert np.isfinite(res.acc).all()


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_mix_resumes_as_an_uninterrupted_run(mode, tmp_path):
    """Checkpoint every step; stop after the first; resume: the same
    traces, losses and params as the uninterrupted run (0 apart)."""
    def spec(d, resume=False, stop=None):
        s = _spec(tapi, mode=mode, rounds=stop or 3)
        if mode == "async":
            s.runtime.total_arrivals = stop or 9
        rt = s.runtime
        rt.checkpoint_dir, rt.checkpoint_every, rt.checkpoint_keep, rt.resume = d, 1, 2, resume
        return s

    full = tapi.run_scenario(spec(str(tmp_path / "full")), device="cpu")
    part = str(tmp_path / "part")
    tapi.run_scenario(spec(part, stop=1 if mode == "sync" else 3), device="cpu")
    resumed = tapi.run_scenario(spec(part, resume=True), device="cpu")
    np.testing.assert_array_equal(resumed.loss, full.loss)
    np.testing.assert_array_equal(resumed.acc, full.acc)
    if mode == "sync":
        np.testing.assert_array_equal(resumed.alloc, full.alloc)
    else:
        for key in EVENTS:
            np.testing.assert_array_equal(getattr(resumed, key), getattr(full, key), err_msg=key)
    for pa, pb in zip(resumed.params, full.params):
        for k, v in _flat(params_to_numpy(pa)).items():
            np.testing.assert_array_equal(v, _flat(params_to_numpy(pb))[k], err_msg=k)


def test_port_step_of_the_mix_resumes_in_the_reference(tmp_path):
    """The port writes a step after each round; all but the first are
    dropped; the reference resumes from it and continues with its own
    uninterrupted run's allocation trace and losses within 1e-5."""
    d = str(tmp_path / "ck")
    spec = _spec(tapi, rounds=2)
    rt = spec.runtime
    rt.checkpoint_dir, rt.checkpoint_every, rt.checkpoint_keep = d, 1, 3
    tapi.run_scenario(spec, device="cpu")
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    for x in steps[1:]:
        shutil.rmtree(os.path.join(d, x))
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write(str(int(steps[0][5:])))
    jspec = _spec(japi, rounds=2)
    jrt = jspec.runtime
    jrt.checkpoint_dir, jrt.checkpoint_every, jrt.checkpoint_keep, jrt.resume = d, 1, 3, True
    resumed = japi.run_scenario(jspec)
    full = _reference_run()
    np.testing.assert_array_equal(resumed.alloc, full.alloc)
    np.testing.assert_allclose(resumed.loss, full.loss, atol=1e-5, rtol=0)


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("archs", [ARCHS, MLA_AUDIO], ids=["mix", "mla_audio"])
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_mix_on_cuda_matches_cpu(mode, archs):
    """The tiny mix on the card and on the CPU: identical allocation or
    event traces, losses within 1e-3; the sync tau 2 folds launch fedavg
    once each, the async fedadam flushes fused_aggregate once each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the GPU machine")
    from repro_torch.kernels import LAUNCHES, reset_launches

    kw = dict(tau=2, backend="vmap") if mode == "sync" else dict(
        mode="async", backend="vmap", aggregator="fedadam")
    spec = _spec(tapi, archs=archs, **kw)
    if mode == "async":
        spec.runtime.aggregator_options = {"lr": 0.1}
    reset_launches()
    gpu = tapi.run_scenario(spec, device="cuda")
    launches = dict(LAUNCHES)
    cpu = tapi.run_scenario(spec, device="cpu")
    if mode == "sync":
        np.testing.assert_array_equal(gpu.alloc, cpu.alloc)
        assert launches["fedavg"] == int((gpu.alloc_counts > 0).sum())
    else:
        for key in EVENTS:
            np.testing.assert_array_equal(getattr(gpu, key), getattr(cpu, key), err_msg=key)
        assert launches["fused_aggregate"] == len(gpu.time)
    np.testing.assert_allclose(gpu.loss, cpu.loss, atol=1e-3, rtol=0)
