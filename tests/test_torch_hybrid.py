"""The port's zamba2 hybrid (Mamba2 + shared attention with LoRA) against the
JAX package's, on the smoke config.

The same seed gives the same model on both sides (``init_hybrid`` draws
from ``repro_torch.prng``; ``A_log`` bit-equal through XLA's f32 log); a
JAX param tree carried across with ``interop.lm_params_from_numpy`` gives
the same loss (atol 1e-5), prefill and decode logits (atol 1e-4) and
greedy tokens. With ``use_pallas`` the loss goes through the flash
attention, SSD scan and gated RMSNorm kernels (their plain versions here,
the Pallas kernels in interpret mode on the JAX side) and must stay within
2e-4 of the plain path, the bound of tests/test_models_smoke.py. The
``cuda`` case runs on a card:

    python -m pytest -q -m cuda tests/test_torch_ssm_kernels.py tests/test_torch_hybrid.py
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import get_api as jax_get_api
from repro.models import ssm as jax_ssm
from repro.models.model import pad_cache as jax_pad_cache
from repro_torch import prng
from repro_torch.configs import get_config, smoke_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.launch import serve
from repro_torch.models import get_api, pad_cache, param_count
from repro_torch.models import ssm
from repro_torch.models.hybrid import n_shared_slots
from repro_torch.tree import tree_leaves, tree_map

ARCH = "zamba2-7b"


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _carry(cfg, seed=3):
    """A JAX model and the same params carried into the port on the CPU."""
    jparams = jax_get_api(cfg).init_params(jax.random.PRNGKey(seed), cfg)
    return jparams, lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _tokens(cfg, B, S, seed=0):
    t = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (B, S), 0, cfg.vocab_size))
    return jnp.asarray(t), torch.from_numpy(t.astype(np.int64))


def _batch(t):
    return {"tokens": t, "labels": t}


# ----------------------------------------------------------------- configs

def test_configs_match_jax():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jax_get_config(ARCH))
    assert dataclasses.asdict(smoke_config(ARCH)) == dataclasses.asdict(jax_smoke_config(ARCH))


def test_param_count_matches_jax():
    """At full width and depth, from shapes alone: the port's tree on the
    meta device against ``jax.eval_shape`` of the JAX init, about 6.79e9
    (tests/test_param_counts.py)."""
    cfg = get_config(ARCH)
    shapes = jax.eval_shape(lambda k: jax_get_api(jax_get_config(ARCH)).init_params(
        k, jax_get_config(ARCH)), jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in _flat(shapes).items()}
    meta = get_api(cfg).init_params(prng.PRNGKey(0), cfg, device="meta")
    assert {k: tuple(v.shape) for k, v in _flat(meta).items()} == want
    total = param_count(meta)
    assert total == sum(int(np.prod(s)) for s in want.values())
    assert abs(total - 6.79e9) / 6.79e9 < 0.02


# ----------------------------------------------------------------- init

def test_init_hybrid_matches_jax():
    cfg = smoke_config(ARCH)
    want = _flat(jax.tree.map(np.asarray, jax_get_api(cfg).init_params(jax.random.PRNGKey(0),
                                                                       cfg)))
    got = _flat(get_api(cfg).init_params(prng.PRNGKey(0), cfg, device="cpu"))
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == torch.float32 and tuple(got[name].shape) == w.shape, name
        np.testing.assert_allclose(got[name].numpy(), w, atol=1e-6, rtol=0, err_msg=name)
    # A_log = log(linspace(1, 16, H)) through XLA:CPU's f32 log: bit-equal
    np.testing.assert_array_max_ulp(got["/layers/mamba/A_log"].numpy(),
                                    want["/layers/mamba/A_log"], maxulp=0)


@pytest.mark.parametrize("nheads", [1, 2, 16, 64, 112])
def test_a_log_within_one_ulp_of_jax(nheads):
    want = np.asarray(jnp.log(jnp.linspace(1.0, 16.0, nheads)))
    got = ssm.a_log_init(nheads)
    assert got.dtype == np.float32 and got.shape == (nheads,)
    np.testing.assert_array_max_ulp(got, want, maxulp=0)


def test_lm_params_from_numpy_refuses_a_hybrid_mismatch():
    cfg = smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, jax_get_api(cfg).init_params(jax.random.PRNGKey(0), cfg))
    no_lora = {k: v for k, v in tree.items() if k != "lora"}
    layers = dict(tree["layers"], mamba={k: v for k, v in tree["layers"]["mamba"].items()
                                         if k != "A_log"})
    for bad, where in ((no_lora, "params"), (dict(tree, layers=layers), "layers/mamba")):
        with pytest.raises(ValueError, match=where):
            lm_params_from_numpy(bad, cfg, device="cpu")


# ----------------------------------------------------------------- SSD core

@pytest.mark.parametrize("L,chunk,G,Hg", [(24, 8, 1, 4), (21, 8, 2, 3), (16, 32, 3, 1)])
def test_ssd_chunked_and_step_match_jax(L, chunk, G, Hg):
    """The model's chunked core with an initial state and G > 1 groups (the
    later mLSTM call), then one ``ssd_step``, against the JAX package's."""
    rng = np.random.default_rng(L + G)
    B, P, N = 2, 8, 4
    x = (0.5 * rng.standard_normal((B, L, G, Hg, P))).astype(np.float32)
    a = -np.logaddexp(rng.standard_normal((B, L, G, Hg)), 0).astype(np.float32)
    b, c = ((0.3 * rng.standard_normal((B, L, G, N))).astype(np.float32) for _ in range(2))
    h0 = (0.1 * rng.standard_normal((B, G, Hg, N, P))).astype(np.float32)
    y, h = ssm.ssd_chunked(*(torch.from_numpy(t) for t in (x, a, b, c)), chunk,
                           torch.from_numpy(h0))
    jy, jh = jax_ssm.ssd_chunked(*(jnp.asarray(t) for t in (x, a, b, c)), chunk, jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5, rtol=1e-5)
    h2, y2 = ssm.ssd_step(h, y[:, -1], torch.from_numpy(a[:, 0]), torch.from_numpy(b[:, 0]),
                          torch.from_numpy(c[:, 0]))
    jh2, jy2 = jax_ssm.ssd_step(jh, jy[:, -1], jnp.asarray(a[:, 0]), jnp.asarray(b[:, 0]),
                                jnp.asarray(c[:, 0]))
    np.testing.assert_allclose(h2.numpy(), np.asarray(jh2), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------- forward

def test_loss_prefill_and_decode_match_jax():
    cfg = smoke_config(ARCH)
    jparams, params = _carry(cfg)
    japi, api = jax_get_api(cfg), get_api(cfg)
    B, P, steps = 2, 16, 3
    tj, tt = _tokens(cfg, B, P + steps)
    lj, _ = japi.loss_fn(jparams, cfg, _batch(tj))
    lt, metrics = api.loss_fn(params, cfg, _batch(tt))
    assert metrics == {}
    np.testing.assert_allclose(lt.item(), float(lj), atol=1e-5)

    gj, cj = japi.prefill_fn(jparams, cfg, _batch(tj[:, :P]))
    gt, ct = api.prefill_fn(params, cfg, _batch(tt[:, :P]))
    assert gt.shape == gj.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4)
    for name, w in _flat(jax.tree.map(np.asarray, cj)).items():
        np.testing.assert_allclose(_flat(ct)[name].numpy(), w, atol=1e-5, err_msg=name)
    cj, ct = jax_pad_cache(cj, P, P + steps), pad_cache(ct, P, P + steps)
    for t in range(P, P + steps):
        gj, cj = japi.decode_fn(jparams, cfg, tj[:, t:t + 1], jnp.int32(t), cj)
        gt, ct = api.decode_fn(params, cfg, tt[:, t:t + 1], t, ct)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4, err_msg=f"pos {t}")
    for name, w in _flat(jax.tree.map(np.asarray, cj)).items():
        np.testing.assert_allclose(_flat(ct)[name].numpy(), w, atol=1e-4, err_msg=name)


def test_client_weighted_loss_matches_jax():
    cfg = smoke_config(ARCH)
    jparams, params = _carry(cfg, seed=4)
    tj, tt = _tokens(cfg, 3, 12, seed=4)
    labels = np.asarray(tj).copy()
    labels[1, :5] = -1
    w = np.array([0.5, 0.2, 0.3], np.float32)
    lj, _ = jax_get_api(cfg).loss_fn(jparams, cfg, {"tokens": tj, "labels": jnp.asarray(labels),
                                                    "client_weights": jnp.asarray(w)})
    lt, _ = get_api(cfg).loss_fn(params, cfg, {"tokens": tt, "labels": torch.from_numpy(labels),
                                               "client_weights": torch.from_numpy(w)})
    np.testing.assert_allclose(lt.item(), float(lj), atol=1e-5)


def test_use_pallas_loss_matches_jax():
    """S = 128 passes the flash gate: attention, scan and gate through the
    kernels' plain versions here and the Pallas kernels on the JAX side."""
    cfg = smoke_config(ARCH)
    jparams, params = _carry(cfg, seed=5)
    tj, tt = _tokens(cfg, 1, 128, seed=5)
    pallas = cfg.replace(use_pallas=True)
    lj, _ = jax_get_api(cfg).loss_fn(jparams, pallas, _batch(tj))
    lt, _ = get_api(cfg).loss_fn(params, pallas, _batch(tt))
    lt_plain, _ = get_api(cfg).loss_fn(params, cfg, _batch(tt))
    assert abs(lt.item() - float(lj)) < 2e-4
    assert abs(lt.item() - lt_plain.item()) < 2e-4


def test_pad_cache_grows_attention_only():
    """The shared slots' KV caches grow along the sequence; the Mamba2
    state and conv window do not."""
    cfg = smoke_config(ARCH)
    _, params = _carry(cfg)
    _, tt = _tokens(cfg, 2, 8)
    _, c = get_api(cfg).prefill_fn(params, cfg, _batch(tt))
    c2 = pad_cache(c, 8, 20)
    n_slots = n_shared_slots(cfg)
    assert c2["shared"]["k"].shape == (n_slots, 2, 20, cfg.n_kv_heads, cfg.hd)
    assert c2["shared"]["v"].shape[2] == 20 and (c2["shared"]["positions"][:, 8:] == -1).all()
    for name in ("state", "conv"):
        assert c2["mamba"][name] is c["mamba"][name]


def test_mamba2_prefill_conv_cache_is_a_copy():
    """The conv cache of a prefill owns its ssm_conv rows: a view of the
    in-projection would hold the whole (B, L, 2 d_inner + 2N + H) product
    alive as long as the cache (every layer's, until the model stacks
    them), with and without ``use_pallas``."""
    for use_pallas in (False, True):
        cfg = smoke_config(ARCH).replace(use_pallas=use_pallas)
        p = ssm.init_mamba2(prng.PRNGKey(1), cfg)
        u = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (2, 16, cfg.d_model)).astype(np.float32))
        _, c = ssm.mamba2_forward(p, cfg, u, return_state=True)
        conv = c["conv"]
        assert conv.untyped_storage().nbytes() == conv.numel() * conv.element_size()


def test_hybrid_cache_size_does_not_grow_with_length():
    """As tests/test_serve.py holds for the JAX package's SSM caches: only
    the shared slots' KV caches depend on the length."""
    cfg = smoke_config(ARCH)
    params = get_api(cfg).init_params(prng.PRNGKey(0), cfg, device="cpu")
    c1 = get_api(cfg).init_cache_fn(params, cfg, 2, 100, torch.float32)
    c2 = get_api(cfg).init_cache_fn(params, cfg, 2, 100_000, torch.float32)
    assert sum(t.numel() for t in tree_leaves(c1["mamba"])) == \
        sum(t.numel() for t in tree_leaves(c2["mamba"]))
    jc = jax_get_api(cfg).init_cache_fn(jax_get_api(cfg).init_params(jax.random.PRNGKey(0), cfg),
                                        cfg, 2, 100, jnp.float32)
    assert {k: tuple(v.shape) for k, v in _flat(c1).items()} == \
        {k: v.shape for k, v in _flat(jax.tree.map(np.asarray, jc)).items()}


# ----------------------------------------------------------------- serving

def _jax_serve_loop(cfg, seed, B, P, G):
    """The JAX package's launch/serve.py loop (its ssm_chunk rule included),
    without its printing."""
    cfg = cfg.replace(ssm_chunk=min(cfg.ssm_chunk, max(8, P // 2)))
    api = jax_get_api(cfg)
    key = jax.random.PRNGKey(seed)
    params = api.init_params(key, cfg)
    prompts = jax.random.randint(key, (B, P), 0, cfg.vocab_size)
    logits, caches = api.prefill_fn(params, cfg, _batch(prompts))
    caches = jax_pad_cache(caches, P, P + G)
    tok = jnp.argmax(logits[:, -1:, :cfg.vocab_size], axis=-1)
    out = [tok]
    for step in range(G - 1):
        logits, caches = api.decode_fn(params, cfg, tok, jnp.int32(P + step), caches)
        tok = jnp.argmax(logits[:, -1:, :cfg.vocab_size], axis=-1)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("P", [8, 40])
def test_generate_matches_jax_serve_loop(P):
    """The same seed on both sides; a 40-token prompt cuts the chunk to
    min(8, 20) and spreads the prompt over several chunks."""
    B, G = 2, 6
    res = serve.main(["--arch", ARCH, "--preset", "tiny", "--device", "cpu", "--batch", str(B),
                      "--prompt-len", str(P), "--gen", str(G), "--seed", "2"])
    assert res.tokens.shape == (B, G)
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  _jax_serve_loop(jax_smoke_config(ARCH), 2, B, P, G))


def test_serve_config_cuts_the_ssm_chunk_as_jax_serve():
    cfg = get_config(ARCH)
    assert serve.serve_config(cfg, 128).ssm_chunk == 64
    assert serve.serve_config(cfg, 4096).ssm_chunk == 256
    assert serve.serve_config(smoke_config(ARCH), 4).ssm_chunk == 8


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels cannot run on the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_hybrid_on_cuda_matches_cpu_and_launches_kernels(cuda_device):
    """The use_pallas loss at S=128 and a short generation on the card: every
    shared attention of the loss goes through flash attention, every Mamba2
    layer through ssd_scan and gated_rmsnorm (decode keeps ssd_step and an
    rmsnorm gate), every norm through rmsnorm; all agree with the CPU."""
    cfg = smoke_config(ARCH).replace(use_pallas=True)
    params = get_api(cfg).init_params(prng.PRNGKey(1), cfg, device="cpu")
    params_gpu = tree_map(lambda t: t.to(cuda_device), params)
    _, tokens = _tokens(cfg, 2, 128, seed=9)
    L, slots = cfg.n_layers, n_shared_slots(cfg)
    norms = L + 2 * slots + 1
    reset_launches()
    l_gpu, _ = get_api(cfg).loss_fn(params_gpu, cfg, _batch(tokens.to(cuda_device)))
    assert dict(LAUNCHES) == {"flash_attention": slots, "ssd_scan": L, "gated_rmsnorm": L,
                              "rmsnorm": norms}
    l_cpu, _ = get_api(cfg).loss_fn(params, cfg, _batch(tokens))
    assert abs(l_gpu.item() - l_cpu.item()) < 1e-4
    reset_launches()
    res_gpu = serve.generate(params_gpu, cfg, tokens[:, :16].to(cuda_device), 5)
    assert dict(LAUNCHES) == {"ssd_scan": L, "gated_rmsnorm": L,
                              "rmsnorm": norms + 4 * (norms + L)}
    res_cpu = serve.generate(params, cfg, tokens[:, :16], 5)
    assert torch.equal(res_gpu.tokens.cpu(), res_cpu.tokens)
