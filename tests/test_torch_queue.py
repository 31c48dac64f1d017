"""The port's serving queue (``launch/queue.py``) against the JAX package's.

The five cases of tests/test_queue.py on the port; then the same requests
(prompts and lengths drawn by numpy from a seed) through both packages'
``WaveBatcher`` (smollm-135m, qwen1.5-0.5b, phi-3-vision and whisper on
their smoke configs) and ``ContinuousBatcher`` (the three decoder-only
ones), from the same params: identical tokens for every request. Per-row
decode (``attn_decode`` and the LM's ``decode_fn`` on a per-row cache with
a (B,) position vector) within 1e-5 of the reference's, the cache
included, and ``_reset_rows`` equal to the reference's. The
``ContinuousBatcher`` refuses every arch type the reference refuses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.queue as jqueue
import repro_torch.launch.queue as tqueue
from repro.configs import smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import get_api as jax_get_api
from repro_torch import prng
from repro_torch.configs import smoke_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch.queue import ContinuousBatcher, Request, WaveBatcher, _reset_rows
from repro_torch.models import attention as tattn
from repro_torch.models import get_api, pad_cache
from repro_torch.tree import tree_map

WAVE_ARCHS = ("smollm-135m", "qwen1.5-0.5b", "phi-3-vision-4.2b", "whisper-medium")
CONTINUOUS_ARCHS = ("smollm-135m", "qwen1.5-0.5b", "phi-3-vision-4.2b")
REFUSED_ARCHS = ("xlstm-1.3b", "qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "zamba2-7b",
                 "whisper-medium")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's worker processes share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batcher(arch="smollm-135m", slots=3):
    cfg = smoke_config(arch)
    api = get_api(cfg)
    params = api.init_params(prng.PRNGKey(0), cfg, device="cpu")
    return WaveBatcher(api, cfg, params, slots=slots, horizon=32), cfg


def _direct(api, cfg, params, prompt, n_new, length=None):
    """A standalone B=1 prefill and greedy decode of ``n_new`` tokens."""
    toks = torch.from_numpy(np.asarray(prompt, np.int64))[None, :]
    P = len(prompt)
    with torch.no_grad():
        lg, caches = api.prefill_fn(params, cfg, {"tokens": toks, "labels": toks})
        caches = pad_cache(caches, P, length or P + n_new + 1)
        t = torch.argmax(lg[:, -1:, :cfg.vocab_size], dim=-1)
        out = [int(t[0, 0])]
        for s in range(n_new - 1):
            lg, caches = api.decode_fn(params, cfg, t, P + s, caches)
            t = torch.argmax(lg[:, :, :cfg.vocab_size], dim=-1)
            out.append(int(t[0, 0]))
    return out


# ------------------------------------------- tests/test_queue.py on the port

def test_queue_serves_all_requests():
    b, cfg = _batcher()
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=4 + i % 3, dtype=np.int32),
                    max_new=3 + i % 4) for i in range(7)]
    for r in reqs:
        b.submit(r)
    stats = b.run()
    assert stats["requests"] == 7
    for r in reqs:
        assert len(r.out) == r.max_new
        assert r.t_done >= r.t_first >= r.t_enqueue


def test_queue_metrics_sane():
    b, cfg = _batcher(slots=2)
    rng = np.random.default_rng(1)
    for i in range(3):
        b.submit(Request(i, rng.integers(0, cfg.vocab_size, size=5, dtype=np.int32), max_new=4))
    stats = b.run()
    assert stats["tokens"] == 12
    assert stats["tok_per_s"] > 0
    assert stats["mean_ttft_s"] <= stats["mean_latency_s"]


def test_queue_greedy_matches_direct_decode():
    """A single request through the queue == direct prefill+decode."""
    b, cfg = _batcher(slots=1)
    prompt = np.arange(1, 7, dtype=np.int32)
    req = Request(0, prompt, max_new=5)
    b.submit(req)
    b.run()
    assert req.out == _direct(b.api, cfg, b.params, prompt, 5, length=20)


def test_continuous_batcher_matches_direct_decode():
    """Per-row-position continuous batching: each request's greedy output
    equals a standalone prefill+decode, even with staggered admission."""
    cfg = smoke_config("qwen1.5-0.5b")
    api = get_api(cfg)
    params = api.init_params(prng.PRNGKey(0), cfg, device="cpu")
    b = ContinuousBatcher(api, cfg, params, slots=2, horizon=32)
    rng = np.random.default_rng(2)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=3 + 2 * i, dtype=np.int32),
                    max_new=4) for i in range(4)]      # 4 requests through 2 slots
    for r in reqs:
        b.submit(r)
    stats = b.run()
    assert stats["requests"] == 4
    for r in reqs:
        assert r.out == _direct(api, cfg, params, r.prompt, r.max_new), r.rid


def test_continuous_batcher_rejects_unsupported_arch():
    cfg = smoke_config("xlstm-1.3b")
    api = get_api(cfg)
    params = api.init_params(prng.PRNGKey(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="per-row decode supports GQA caches"):
        ContinuousBatcher(api, cfg, params)


# --------------------------------------------------- against the reference

def _models(arch, seed=0):
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    jparams = jax_get_api(jcfg).init_params(jax.random.PRNGKey(seed), jcfg)
    return (jcfg, jparams), (cfg, lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                                       device="cpu"))


def _requests(module, vocab, n, seed):
    """``n`` requests of 3-10 prompt tokens and 2-6 new ones, drawn from
    ``seed``, as ``module.Request``s."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        P, G = int(rng.integers(3, 11)), int(rng.integers(2, 7))
        out.append(module.Request(i, rng.integers(0, vocab, size=P, dtype=np.int32), max_new=G))
    return out


def _serve_both(kind, arch, n=7, slots=3, horizon=32, seed=11):
    (jcfg, jparams), (cfg, params) = _models(arch)
    jb = getattr(jqueue, kind)(jax_get_api(jcfg), jcfg, jparams, slots=slots, horizon=horizon)
    tb = getattr(tqueue, kind)(get_api(cfg), cfg, params, slots=slots, horizon=horizon)
    jreqs = _requests(jqueue, cfg.vocab_size, n, seed)
    treqs = _requests(tqueue, cfg.vocab_size, n, seed)
    for jr, tr in zip(jreqs, treqs):
        jb.submit(jr)
        tb.submit(tr)
    jstats, tstats = jb.run(), tb.run()
    return jreqs, treqs, jstats, tstats


@pytest.mark.parametrize("arch", WAVE_ARCHS)
def test_wave_batcher_matches_reference(arch):
    jreqs, treqs, jstats, tstats = _serve_both("WaveBatcher", arch)
    assert {k: tstats[k] for k in ("requests", "tokens")} == \
        {k: jstats[k] for k in ("requests", "tokens")}
    assert set(tstats) == set(jstats)
    for jr, tr in zip(jreqs, treqs):
        assert tr.out == jr.out, tr.rid
        assert len(tr.out) == tr.max_new and tr.t_done >= tr.t_first >= tr.t_enqueue


@pytest.mark.parametrize("arch", CONTINUOUS_ARCHS)
def test_continuous_batcher_matches_reference(arch):
    jreqs, treqs, jstats, tstats = _serve_both("ContinuousBatcher", arch, slots=2)
    assert {k: tstats[k] for k in ("requests", "tokens")} == \
        {k: jstats[k] for k in ("requests", "tokens")}
    for jr, tr in zip(jreqs, treqs):
        assert tr.out == jr.out, tr.rid
        assert len(tr.out) == tr.max_new and tr.t_done >= tr.t_first >= tr.t_enqueue


def test_continuous_batcher_feeds_a_vlm_no_image():
    """As in the reference, decode embeds tokens only: a phi-3 request
    equals a direct text-only prefill and decode."""
    cfg = smoke_config("phi-3-vision-4.2b")
    api = get_api(cfg)
    params = api.init_params(prng.PRNGKey(3), cfg, device="cpu")
    b = ContinuousBatcher(api, cfg, params, slots=2, horizon=32)
    req = Request(0, np.arange(2, 9, dtype=np.int32), max_new=4)
    b.submit(req)
    b.run()
    assert req.out == _direct(api, cfg, params, req.prompt, req.max_new)


@pytest.mark.parametrize("arch", REFUSED_ARCHS)
def test_continuous_batcher_refuses_what_the_reference_refuses(arch):
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    with pytest.raises(AssertionError):
        jqueue.ContinuousBatcher(jax_get_api(jcfg), jcfg, None)
    with pytest.raises(ValueError, match=repr(cfg.arch_type)):
        ContinuousBatcher(get_api(cfg), cfg, None)


# ----------------------------------------------------------- per-row decode

def _perrow_positions(B, W, seed):
    """Each row at its own position (some past W, so the slots roll)."""
    return np.random.default_rng(seed).integers(0, 2 * W, size=B).astype(np.int32)


@pytest.mark.parametrize("window", [0, 3])
def test_per_row_attn_decode_matches_reference(window):
    (jcfg, jparams), (cfg, params) = _models("qwen1.5-0.5b", seed=4)
    jcfg, cfg = jcfg.replace(sliding_window=window), cfg.replace(sliding_window=window)
    jp = jax.tree.map(lambda t: t[0], jparams["dense_layers"]["attn"])
    tp = tree_map(lambda t: t[0], params["dense_layers"]["attn"])
    B, W = 3, 6
    rng = np.random.default_rng(5)
    jc = jattn.init_cache(jcfg, B, W, jnp.float32, per_row=True)
    tc = tattn.init_cache(cfg, B, W, torch.float32, "cpu", per_row=True)
    assert tuple(tc["positions"].shape) == jc["positions"].shape == (B, W)
    start = _perrow_positions(B, W, 6)
    for step in range(8):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        pos = start + step
        yj, jc = jattn.attn_decode(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), jc)
        yt, tc = tattn.attn_decode(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos), tc)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5, err_msg=f"step {step}")
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tc["positions"].numpy(), np.asarray(jc["positions"]))


@pytest.mark.parametrize("arch", CONTINUOUS_ARCHS)
def test_per_row_lm_decode_matches_reference(arch):
    (jcfg, jparams), (cfg, params) = _models(arch, seed=7)
    B, W = 3, 12
    jc = jax_get_api(jcfg).init_cache_fn(jparams, jcfg, B, W, jnp.float32, per_row=True)
    tc = get_api(cfg).init_cache_fn(params, cfg, B, W, torch.float32, per_row=True)
    assert tuple(tc["dense"]["positions"].shape) == jc["dense"]["positions"].shape
    rng = np.random.default_rng(8)
    pos = np.array([0, 4, 9], np.int32)
    for step in range(5):
        tok = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        gj, jc = jax_get_api(jcfg).decode_fn(jparams, jcfg, jnp.asarray(tok),
                                             jnp.asarray(pos + step), jc)
        gt, tc = get_api(cfg).decode_fn(params, cfg, torch.from_numpy(tok.astype(np.int64)),
                                        torch.from_numpy(pos + step), tc)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-5, err_msg=f"step {step}")
    np.testing.assert_array_equal(tc["dense"]["positions"].numpy(),
                                  np.asarray(jc["dense"]["positions"]))


def test_reset_rows_matches_reference():
    (jcfg, jparams), (cfg, params) = _models("smollm-135m")
    B, W = 4, 5
    jc = jax_get_api(jcfg).init_cache_fn(jparams, jcfg, B, W, jnp.float32, per_row=True)
    tc = get_api(cfg).init_cache_fn(params, cfg, B, W, torch.float32, per_row=True)
    filled = np.arange(cfg.n_layers * B * W, dtype=np.int32).reshape(cfg.n_layers, B, W)
    jc = dict(jc, dense=dict(jc["dense"], positions=jnp.asarray(filled)))
    tc["dense"]["positions"].copy_(torch.from_numpy(filled))
    want = jqueue._reset_rows(jc, [1, 3])
    got = _reset_rows(tc, [1, 3])
    for k in ("k", "v", "positions"):
        np.testing.assert_array_equal(got["dense"][k].numpy(), np.asarray(want["dense"][k]))
    assert (got["dense"]["positions"][:, [1, 3]] == -1).all()
    assert (got["dense"]["positions"][:, [0, 2]] >= 0).all()
