"""The port's checkpoint layer against the JAX package's.

``repro_torch.checkpoint`` writes the reference's layout (MANIFEST.json
with ``structure``/``dtypes``/``metadata``, arrays.npz keyed by tree path
with '/' as '|', bf16 as its uint16 bits). Pytrees round-trip in f32,
bf16 and int; a directory written by either package loads in the other
with identical structure, keys and dtypes; the manager keeps the
reference's retention, restore and ``begin`` semantics (the kind guard,
the stale-step clear).
"""
import json
import os
import zipfile

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.checkpoint as jck
import repro_torch.checkpoint as tck
from repro_torch.interop import load_numpy_pytree


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


def _torch_tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.ones(2, dtype=torch.int32),
                   "c": [torch.zeros(3), torch.full((2, 2), 7.0)]},
        "t": (torch.tensor(1.0), torch.tensor(2, dtype=torch.int64)),
        "h": torch.linspace(-2, 2, 64).to(torch.bfloat16),
        "flag": torch.tensor([True, False]),
    }


def _manifest(path):
    with open(os.path.join(path, "MANIFEST.json")) as f:
        return json.load(f)


def _npz_keys(path):
    with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as z:
        return sorted(z.namelist())


def test_pytree_roundtrip_f32_bf16_int(tmp_path):
    tree = _torch_tree()
    p = str(tmp_path / "ck")
    tck.save_pytree(p, tree, metadata={"round": 7})
    back, meta = tck.load_pytree(p)
    assert meta == {"round": 7}
    assert isinstance(back["t"], tuple) and isinstance(back["nested"]["c"], list)
    flat_a = dict(tck.checkpoint._flatten(tree))
    flat_b = dict(tck.checkpoint._flatten(back))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        assert flat_b[k].dtype == flat_a[k].dtype and flat_b[k].device.type == "cpu", k
        assert torch.equal(flat_b[k], flat_a[k]), k
    assert _manifest(p)["dtypes"]["h"] == "bfloat16"


def test_load_like_casts_onto_template(tmp_path):
    p = str(tmp_path / "ck")
    tck.save_pytree(p, {"w": torch.arange(4, dtype=torch.float32)})
    like = {"w": torch.zeros(4, dtype=torch.float64)}
    back, _ = tck.load_pytree(p, like=like)
    assert back["w"].dtype == torch.float64
    np.testing.assert_array_equal(back["w"].numpy(), np.arange(4.0))


def test_port_step_loads_in_reference(tmp_path):
    """A pytree the port writes loads in the reference's ``load_pytree``:
    identical structure, keys, dtypes (bf16 as ml_dtypes) and values."""
    tree = _torch_tree()
    p = str(tmp_path / "port")
    tck.save_pytree(p, tree, metadata={"task": "x"})
    ref_tree, meta = jck.load_pytree(p)
    assert meta == {"task": "x"}
    assert isinstance(ref_tree["t"], tuple) and isinstance(ref_tree["nested"]["c"], list)
    assert ref_tree["h"].dtype == ml_dtypes.bfloat16
    for (kp, lp), (kr, lr) in zip(tck.checkpoint._flatten(tree),
                                  tck.checkpoint._flatten(ref_tree)):
        assert kp == kr
        want = lp.float().numpy() if lp.dtype == torch.bfloat16 else lp.numpy()
        np.testing.assert_array_equal(np.asarray(lr, want.dtype), want)
        assert str(lr.dtype) == ("bfloat16" if lp.dtype == torch.bfloat16 else str(want.dtype))


def test_reference_step_loads_in_port(tmp_path):
    """The other way round: the reference's files (written from jax arrays)
    give the port the same structure, keys, dtypes and values, and both
    writers produce the same manifest and npz keys for the same tree."""
    jtree = {
        "a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
        "nested": {"b": jnp.ones((2,), jnp.int32), "c": [jnp.zeros(3), jnp.full((2, 2), 7.0)]},
        "t": (jnp.array(1.0), jnp.array(2)),
        "h": jnp.linspace(-2, 2, 64).astype(jnp.bfloat16),
    }
    pj, pt = str(tmp_path / "ref"), str(tmp_path / "port")
    jck.save_pytree(pj, jtree, metadata={"step": 3})
    back, meta = tck.load_pytree(pj)
    assert meta == {"step": 3}
    assert back["h"].dtype == torch.bfloat16 and back["nested"]["b"].dtype == torch.int32
    for (kj, lj), (kt, lt) in zip(tck.checkpoint._flatten(jtree), tck.checkpoint._flatten(back)):
        assert kj == kt
        np.testing.assert_array_equal(lt.float().numpy(), np.asarray(lj, np.float32))
    tck.save_pytree(pt, back, metadata={"step": 3})
    assert _manifest(pt) == _manifest(pj)
    assert _npz_keys(pt) == _npz_keys(pj)
    numpy_tree, _ = load_numpy_pytree(pj)
    np.testing.assert_array_equal(numpy_tree["h"], np.asarray(jtree["h"], np.float32))
    assert numpy_tree["nested"]["b"].dtype == np.int32


def test_numpy_pytree_roundtrip_through_interop(tmp_path):
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "n": [np.int64(3)]}
    p = str(tmp_path / "np")
    tck.save_pytree(p, tree, {"k": 1})
    back, meta = load_numpy_pytree(p)
    assert meta == {"k": 1}
    np.testing.assert_array_equal(back["w"], tree["w"])
    assert back["n"][0] == 3
    jback, _ = jck.load_pytree(p)
    np.testing.assert_array_equal(np.asarray(jback["w"]), tree["w"])


def test_manager_latest_and_retention(tmp_path):
    m = tck.CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        m.save(step, {"taskA": {"x": torch.full((2,), step)}},
               coordinator_state={"losses": {"taskA": 1.0 / step}})
    assert m.latest_step() == 4
    assert m.steps() == [3, 4]
    step, tasks, coord = m.restore()
    assert step == 4 and float(tasks["taskA"]["x"][0]) == 4.0
    assert coord["losses"]["taskA"] == 0.25
    # the reference's manager reads the port's directory the same way
    jstep, jtasks, jcoord = jck.CheckpointManager(str(tmp_path), keep=2).restore()
    assert jstep == 4 and float(jtasks["taskA"]["x"][0]) == 4.0 and jcoord == coord


def test_manager_restore_specific_step(tmp_path):
    m = tck.CheckpointManager(str(tmp_path), keep=5)
    m.save(10, {"t": {"x": torch.zeros(1)}})
    m.save(20, {"t": {"x": torch.ones(1)}})
    step, tasks, _ = m.restore(10)
    assert step == 10 and float(tasks["t"]["x"][0]) == 0.0


def test_manager_empty_dir(tmp_path):
    m = tck.CheckpointManager(str(tmp_path))
    assert m.latest_step() is None
    assert m.restore() is None


@pytest.mark.parametrize("writer,resumer,match", [
    ("async", "sync", "written by the async engine"),
    ("sync", "async", "no async engine state"),
    ("sync_fed", "sync", "engine kind 'sync_fed'"),
])
def test_begin_refuses_another_engine_kind(tmp_path, writer, resumer, match):
    """``begin``'s kind guard, with the reference's messages; the foreign
    steps survive the refusal."""
    d = str(tmp_path / "ck")
    m = tck.CheckpointManager(d)
    m.append_history({"kind": "round"})
    m.save(2, {"t": {"w": torch.zeros(2)}}, {"c": 1}, engine_kind=writer)
    m.close()
    with pytest.raises(ValueError, match=match):
        tck.CheckpointManager(d).begin(resumer, resume=True)
    assert tck.CheckpointManager(d).latest_step() == 2


def test_begin_replays_committed_history_and_truncates_tail(tmp_path):
    d = str(tmp_path / "ck")
    m = tck.CheckpointManager(d, keep=3)
    m.append_history({"kind": "flush", "i": 0})
    m.save(1, {"t": {"w": torch.ones(2)}}, {"s": 1}, engine_kind="async")
    m.append_history({"kind": "flush", "i": 1})       # never committed
    m.close()
    with open(os.path.join(d, "history.jsonl"), "ab") as f:
        f.write(b'{"kind":"to')                        # a torn line
    hit = tck.CheckpointManager(d).begin("async", resume=True)
    assert hit.step == 1 and hit.history == [{"kind": "flush", "i": 0}]
    assert hit.coordinator == {"s": 1}
    assert os.path.getsize(os.path.join(d, "history.jsonl")) == \
        json.load(open(os.path.join(d, "step_00000001", "STEP.json")))["history_offset"]


def test_begin_fresh_clears_stale_steps_and_sidecar(tmp_path):
    """A fresh run in a used directory clears the old steps and sidecar;
    resume into a directory of partial junk starts fresh and clears it."""
    d = str(tmp_path / "ck")
    m = tck.CheckpointManager(d)
    m.append_history({"kind": "round"})
    m.save(9, {"t": {"w": torch.zeros(1)}}, {}, engine_kind="sync")
    m.close()
    fresh = tck.CheckpointManager(d)
    assert fresh.begin("sync", resume=False) is None
    assert fresh.steps() == [] and not os.path.exists(fresh.history_path)
    assert not os.path.exists(os.path.join(d, "LATEST"))
    os.makedirs(os.path.join(d, "step_00000050"))     # partial: no STEP.json
    assert tck.CheckpointManager(d).begin("sync", resume=True) is None
    assert not os.path.isdir(os.path.join(d, "step_00000050"))


def test_begin_embedded_history_step_returns_none_history(tmp_path):
    """A step without ``history_offset`` (history embedded in the payload)
    resumes with ``history=None`` and an emptied sidecar, as the
    reference's ``begin``."""
    d = str(tmp_path / "ck")
    m = tck.CheckpointManager(d)
    m.save(4, {"t": {"w": torch.zeros(1)}}, {"async": {"x": 1}})     # no engine stamp
    with open(m.history_path, "w") as f:
        f.write('{"kind":"assign"}\n')
    hit = tck.CheckpointManager(d).begin("async", resume=True)
    assert hit.step == 4 and hit.history is None
    assert os.path.getsize(m.history_path) == 0
    jhit = jck.CheckpointManager(d).begin("async", resume=True)
    assert jhit.step == 4 and jhit.coordinator == hit.coordinator


def test_model_params_and_adamw_state_roundtrip(tmp_path):
    """An LM's params and AdamW state (an int32 0-d count) saved by the
    port give a bit-identical loss after the restore."""
    from repro_torch import prng
    from repro_torch.configs import smoke_config
    from repro_torch.models import get_api
    from repro_torch.optim import adamw

    cfg = smoke_config("qwen3-0.6b")
    api = get_api(cfg)
    params = api.init_params(prng.PRNGKey(0, device="cpu"), cfg, device="cpu")
    state = adamw().init(params)
    p = str(tmp_path / "task")
    tck.save_pytree(p, {"params": params, "opt": state})
    back, _ = tck.load_pytree(p)
    assert back["opt"]["count"].dtype == torch.int32 and back["opt"]["count"].shape == ()
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks}
    with torch.no_grad():
        assert float(api.loss_fn(params, cfg, batch)[0]) == float(
            api.loss_fn(back["params"], cfg, batch)[0])
    # and the reference reads the same files leaf for leaf
    jback, _ = jck.load_pytree(p)
    flat_t = dict(tck.checkpoint._flatten(back))
    flat_j = dict(tck.checkpoint._flatten(jback))
    assert flat_t.keys() == flat_j.keys()
    for k in flat_t:
        np.testing.assert_array_equal(np.asarray(flat_j[k], np.float32),
                                      flat_t[k].float().numpy(), err_msg=k)
