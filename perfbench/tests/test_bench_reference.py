"""The plain reference against the port on the CPU at the smoke size: the
same weights give the same loss, gradients and probe logits; a whole tiny
run of each cell's traffic comes out correct."""

import math

import numpy as np
import pytest
import torch

from perfbench.reference import mmfl
from perfbench.reference.common import ModelConfig, leaves
from perfbench.tests.conftest import BENCH, SEQ, tiny_cell

ARCHS = ("phi-3-vision-4.2b", "deepseek-v2-lite-16b", "whisper-medium")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _configs(arch):
    import dataclasses

    from repro_torch.configs import smoke_config

    port = smoke_config(arch)
    port = port.replace(ssm_chunk=min(port.ssm_chunk, max(8, SEQ // 4)))
    return port, ModelConfig.from_dict(dataclasses.asdict(port))


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    data = mmfl.dataset(cfg.vocab_size, 4, 3, SEQ, seed)
    return mmfl.assemble(cfg, 4, SEQ, data, np.array([0, 2]), 4, rng, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_and_logits_match_the_port(arch):
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models import get_api

    port_cfg, cfg = _configs(arch)
    params = mmfl.weights(cfg, 7, "cpu")
    batch = _batch(cfg, 3)
    api = get_api(port_cfg)
    loss, grads = loss_and_grads(api, port_cfg, params, batch)
    ref_loss, ref_grads = mmfl.loss_and_grads(cfg, params, batch)
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    got, want = dict(leaves(grads)), dict(leaves(ref_grads))
    assert got.keys() == want.keys()
    scale = max(float(g.abs().max()) for g in want.values())
    for path in want:
        assert float((got[path] - want[path]).abs().max()) <= 1e-5 * max(1.0, scale), path
    probe = mmfl.probe_batch(cfg, mmfl.dataset(cfg.vocab_size, 8, 2, SEQ, 5), "cpu")
    with torch.no_grad():
        logits, _ = api.prefill_fn(params, port_cfg, probe)
        ref = mmfl.family(cfg).last_logits(params, cfg, probe)
    assert torch.allclose(logits[:, -1], ref, atol=1e-4, rtol=1e-4)


def test_the_weights_are_the_ports_tree():
    from repro_torch import prng
    from repro_torch.models import get_api

    for arch in ARCHS:
        port_cfg, cfg = _configs(arch)
        port = get_api(port_cfg).init_params(prng.PRNGKey(0, device="cpu"), port_cfg, device="cpu")
        got = {p: (tuple(t.shape), t.dtype) for p, t in leaves(port)}
        want = {p: (tuple(t.shape), t.dtype) for p, t in leaves(mmfl.weights(cfg, 1, "cpu"))}
        assert got == want, arch


def test_weights_follow_the_seed():
    _, cfg = _configs("phi-3-vision-4.2b")
    a, b, c = (dict(leaves(mmfl.weights(cfg, s, "cpu"))) for s in (2**33 + 5, 2**33 + 5, 6))
    assert all(torch.equal(a[p], b[p]) for p in a)
    assert not torch.equal(a["head"], c["head"])


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_run_is_correct(name):
    from perfbench.run import run_cell

    out = run_cell(tiny_cell(name), 2**31 + 12345, 1.0, False, torch.device("cpu"))
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    for v in out["compared"].values():
        assert math.isfinite(v["value"]) and v["value"] <= v["limit"]
    assert out["metrics"]["train_tokens_per_s"]["value"] > 0
