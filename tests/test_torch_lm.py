"""The port's dense LM against the JAX package's, on the smoke configs.

The same seed gives the same model on both sides (``init_lm`` draws from
``repro_torch.prng``); a JAX param tree carried across with
``interop.lm_params_from_numpy`` gives the same loss (atol 1e-5), prefill
and decode logits (atol 1e-4) and greedy tokens. With ``use_pallas`` the
loss goes through the flash attention kernel (its plain version here, the
Pallas kernel in interpret mode on the JAX side) and must stay within
2e-4 of the JAX loss, the bound of tests/test_models_smoke.py. The
``cuda`` cases run on a card:

    python -m pytest -q -m cuda tests/test_torch_lm_kernels.py tests/test_torch_lm.py
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
from repro.models.model import pad_cache as jax_pad_cache
from repro.models.transformer import init_lm as jax_init_lm
from repro_torch import prng
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.launch import serve
from repro_torch.models import get_api, pad_cache, param_count
from repro_torch.models.transformer import init_lm
from repro_torch.tree import tree_map

ARCHS = ("smollm-135m", "qwen3-0.6b", "qwen1.5-0.5b")
DENSE = ("qwen1.5-0.5b", "qwen1.5-110b", "qwen3-0.6b", "smollm-135m")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _carry(cfg, seed=3):
    """A JAX model and the same params carried into the port on the CPU."""
    jparams = jax_init_lm(jax.random.PRNGKey(seed), cfg)
    return jparams, lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _tokens(cfg, B, S, seed=0):
    t = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (B, S), 0, cfg.vocab_size))
    return jnp.asarray(t), torch.from_numpy(t.astype(np.int64))


# ----------------------------------------------------------------- configs

def test_port_registers_the_dense_archs():
    assert list_archs() == tuple(sorted(DENSE + ("zamba2-7b", "qwen2-moe-a2.7b", "xlstm-1.3b",
                                                 "deepseek-v2-lite-16b", "whisper-medium",
                                                 "phi-3-vision-4.2b")))


@pytest.mark.parametrize("arch", DENSE)
def test_configs_match_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(smoke_config(arch)) == dataclasses.asdict(jax_smoke_config(arch))
    assert get_config(arch).padded_vocab == jax_get_config(arch).padded_vocab


@pytest.mark.parametrize("arch", DENSE)
def test_param_count_matches_jax(arch):
    """At full width, from shapes alone: the port's tree on the meta device
    against ``jax.eval_shape`` of the JAX init."""
    cfg = get_config(arch)
    shapes = jax.eval_shape(lambda k: jax_init_lm(k, jax_get_config(arch)),
                            jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in _flat(shapes).items()}
    meta = init_lm(prng.PRNGKey(0), cfg, device="meta")
    assert {k: tuple(v.shape) for k, v in _flat(meta).items()} == want
    assert param_count(meta) == sum(int(np.prod(s)) for s in want.values())


# ----------------------------------------------------------------- init

@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_matches_jax(arch):
    cfg = smoke_config(arch)
    want = _flat(jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(7), cfg)))
    got = _flat(get_api(cfg).init_params(prng.PRNGKey(7), cfg, device="cpu"))
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == torch.float32 and tuple(got[name].shape) == w.shape, name
        np.testing.assert_allclose(got[name].numpy(), w, atol=1e-6, rtol=0, err_msg=name)


def test_init_lm_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_lm(prng.PRNGKey(0), smoke_config("smollm-135m"))


def test_lm_params_from_numpy_refuses_mismatches():
    cfg = smoke_config("qwen3-0.6b")
    tree = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(0), cfg))
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    bad_shape = dict(tree, final_norm=np.ones(cfg.d_model + 1, np.float32))
    bad_dtype = dict(tree, final_norm=np.ones(cfg.d_model, np.float64))
    layers = dict(tree["dense_layers"], attn={k: v for k, v in tree["dense_layers"]["attn"].items()
                                              if k != "q_norm"})
    no_qk_norm = dict(tree, dense_layers=layers)
    for bad, where in ((missing, "params"), (bad_shape, "final_norm"),
                       (bad_dtype, "final_norm"), (no_qk_norm, "dense_layers/attn")):
        with pytest.raises(ValueError, match=where):
            lm_params_from_numpy(bad, cfg, device="cpu")


def test_lm_params_from_numpy_carries_bf16_bits():
    cfg = smoke_config("smollm-135m").replace(param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(2), cfg))
    got = _flat(lm_params_from_numpy(tree, cfg, device="cpu"))
    for name, w in _flat(tree).items():
        assert got[name].dtype == torch.bfloat16, name
        np.testing.assert_array_equal(got[name].float().numpy(), w.astype(np.float32))


# ----------------------------------------------------------------- forward

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_prefill_and_decode_match_jax(arch):
    cfg = smoke_config(arch)
    jparams, params = _carry(cfg)
    japi, api = jax_get_api(cfg), get_api(cfg)
    B, P, steps = 2, 16, 3
    tj, tt = _tokens(cfg, B, P + steps)
    lj, _ = japi.loss_fn(jparams, cfg, {"tokens": tj, "labels": tj})
    lt, metrics = api.loss_fn(params, cfg, {"tokens": tt, "labels": tt})
    assert metrics == {"aux": 0.0}
    np.testing.assert_allclose(lt.item(), float(lj), atol=1e-5)

    gj, cj = japi.prefill_fn(jparams, cfg, {"tokens": tj[:, :P], "labels": tj[:, :P]})
    gt, ct = api.prefill_fn(params, cfg, {"tokens": tt[:, :P], "labels": tt[:, :P]})
    assert gt.shape == gj.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4)
    np.testing.assert_allclose(ct["dense"]["k"].numpy(), np.asarray(cj["dense"]["k"]), atol=1e-5)
    cj, ct = jax_pad_cache(cj, P, P + steps), pad_cache(ct, P, P + steps)
    for t in range(P, P + steps):
        gj, cj = japi.decode_fn(jparams, cfg, tj[:, t:t + 1], jnp.int32(t), cj)
        gt, ct = api.decode_fn(params, cfg, tt[:, t:t + 1], t, ct)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4, err_msg=f"pos {t}")
    np.testing.assert_array_equal(ct["dense"]["positions"].numpy(),
                                  np.asarray(cj["dense"]["positions"]))


def test_client_weighted_loss_matches_jax():
    cfg = smoke_config("smollm-135m")
    jparams, params = _carry(cfg)
    tj, tt = _tokens(cfg, 3, 12, seed=4)
    labels = np.asarray(tj).copy()
    labels[1, :5] = -1                                   # masked positions
    w = np.array([0.5, 0.2, 0.3], np.float32)
    lj, _ = jax_get_api(cfg).loss_fn(jparams, cfg, {"tokens": tj, "labels": jnp.asarray(labels),
                                                    "client_weights": jnp.asarray(w)})
    lt, _ = get_api(cfg).loss_fn(params, cfg, {"tokens": tt, "labels": torch.from_numpy(labels),
                                               "client_weights": torch.from_numpy(w)})
    np.testing.assert_allclose(lt.item(), float(lj), atol=1e-5)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen1.5-0.5b"])
def test_use_pallas_loss_matches_jax(arch):
    """S = 128 passes the ``S % 128 == 0`` gate: the flash path on both
    sides, against each other and against the port's chunked path."""
    cfg = smoke_config(arch)
    jparams, params = _carry(cfg, seed=5)
    tj, tt = _tokens(cfg, 1, 128, seed=5)
    pallas = cfg.replace(use_pallas=True)
    lj, _ = jax_get_api(cfg).loss_fn(jparams, pallas, {"tokens": tj, "labels": tj})
    lt, _ = get_api(cfg).loss_fn(params, pallas, {"tokens": tt, "labels": tt})
    lt_plain, _ = get_api(cfg).loss_fn(params, cfg, {"tokens": tt, "labels": tt})
    assert abs(lt.item() - float(lj)) < 2e-4
    assert abs(lt.item() - lt_plain.item()) < 2e-4


def test_sliding_window_decode_matches_jax():
    """A cache of W = sliding_window slots rolls (slot = pos % W)."""
    cfg = smoke_config("qwen3-0.6b").replace(sliding_window=4)
    jparams, params = _carry(cfg.replace(sliding_window=0))
    tj, tt = _tokens(cfg, 2, 7, seed=6)
    cj = jax_get_api(cfg).init_cache_fn(jparams, cfg, 2, 4, jnp.float32)
    ct = get_api(cfg).init_cache_fn(params, cfg, 2, 4, torch.float32)
    for t in range(7):
        gj, cj = jax_get_api(cfg).decode_fn(jparams, cfg, tj[:, t:t + 1], jnp.int32(t), cj)
        gt, ct = get_api(cfg).decode_fn(params, cfg, tt[:, t:t + 1], t, ct)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4, err_msg=f"pos {t}")


def test_pad_cache_grows_kv_only():
    cfg = smoke_config("qwen1.5-0.5b")
    params = init_lm(prng.PRNGKey(7), cfg, device="cpu")
    c = get_api(cfg).init_cache_fn(params, cfg, 2, 8, torch.float32)
    assert c["dense"]["k"].shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.hd)
    c2 = pad_cache(c, 8, 20)
    assert c2["dense"]["k"].shape[2] == 20 and c2["dense"]["v"].shape[2] == 20
    assert (c2["dense"]["positions"][:, 8:] == -1).all()


# ----------------------------------------------------------------- serving

def _jax_serve_loop(cfg, seed, B, P, G):
    """The JAX package's launch/serve.py loop, without its printing."""
    api = jax_get_api(cfg)
    key = jax.random.PRNGKey(seed)
    params = api.init_params(key, cfg)
    prompts = jax.random.randint(key, (B, P), 0, cfg.vocab_size)
    logits, caches = api.prefill_fn(params, cfg, {"tokens": prompts, "labels": prompts})
    caches = jax_pad_cache(caches, P, P + G)
    tok = jnp.argmax(logits[:, -1:, :cfg.vocab_size], axis=-1)
    out = [tok]
    for step in range(G - 1):
        logits, caches = api.decode_fn(params, cfg, tok, jnp.int32(P + step), caches)
        tok = jnp.argmax(logits[:, -1:, :cfg.vocab_size], axis=-1)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax_serve_loop(arch):
    """The same seed on both sides: the model and the prompts are drawn
    from it, then greedy tokens must be identical."""
    B, P, G = 2, 8, 6
    res = serve.main(["--arch", arch, "--preset", "tiny", "--device", "cpu", "--batch", str(B),
                      "--prompt-len", str(P), "--gen", str(G), "--seed", "2"])
    assert res.tokens.shape == (B, G) and res.prefill_s > 0 and res.decode_s > 0
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  _jax_serve_loop(jax_smoke_config(arch), 2, B, P, G))


def test_generate_with_carried_params_counts_no_kernel_on_cpu():
    cfg = smoke_config("smollm-135m")
    _, params = _carry(cfg)
    _, prompts = _tokens(cfg, 3, 8, seed=8)
    reset_launches()
    res = serve.generate(params, cfg, prompts, 4)
    assert res.tokens.shape == (3, 4) and not LAUNCHES
    assert (res.tokens >= 0).all() and (res.tokens < cfg.vocab_size).all()


def test_serve_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "smollm-135m", "--preset", "tiny"])


# ----------------------------------------------------------------- refusals

@pytest.mark.parametrize("change,item", [
    (dict(arch_type="vlm"), "item 10"), (dict(n_img_tokens=8), "item 10"),
])
def test_unported_configs_are_refused_by_name(change, item):
    """The vlm family is ported (tests/test_torch_vlm.py): these configs,
    once refused naming ROADMAP ``item``, now build and give the JAX
    package's loss (1e-5) with image embeddings ahead of the text, and an
    arch type the JAX package does not have is still refused."""
    cfg = smoke_config("smollm-135m").replace(**change)
    jcfg = jax_smoke_config("smollm-135m").replace(**change)
    jparams, params = _carry(cfg)
    tj, tt = _tokens(cfg, 2, 10, seed=9)
    img = np.random.default_rng(9).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    lj, _ = jax_get_api(jcfg).loss_fn(jparams, jcfg, {"tokens": tj, "labels": tj,
                                                      "img_embeds": jnp.asarray(img)})
    lt, _ = get_api(cfg).loss_fn(params, cfg, {"tokens": tt, "labels": tt,
                                               "img_embeds": torch.from_numpy(img)})
    np.testing.assert_allclose(lt.item(), float(lj), atol=1e-5)
    assert init_lm(prng.PRNGKey(0), cfg, device="cpu").keys() == params.keys()
    with pytest.raises(NotImplementedError, match="not an arch type of the JAX package"):
        get_api(cfg.replace(arch_type="diffusion"))


@pytest.mark.parametrize("change", [
    dict(arch_type="moe"), dict(arch_type="ssm", slstm_every=2), dict(arch_type="ssm"),
    dict(n_experts=4, top_k=2, moe_d_ff=64),
], ids=["moe", "ssm_slstm", "ssm_mlstm_only", "experts"])
def test_formerly_refused_config_runs(change):
    """The MoE and xLSTM families are ported (tests/test_torch_moe.py,
    test_torch_xlstm.py, test_torch_lm_families.py): these configs, once
    refused by name, now build and give the JAX package's loss (1e-5).
    The experts case names an expert width: at smollm's moe_d_ff of 0 the
    JAX package's init itself fails (0 ** -0.5)."""
    cfg = smoke_config("smollm-135m").replace(**change)
    jcfg = jax_smoke_config("smollm-135m").replace(**change)
    jparams = jax_get_api(jcfg).init_params(jax.random.PRNGKey(1), jcfg)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    tj, tt = _tokens(cfg, 2, 12)
    lj, _ = jax_get_api(jcfg).loss_fn(jparams, jcfg, {"tokens": tj, "labels": tj})
    lt, _ = get_api(cfg).loss_fn(params, cfg, {"tokens": tt, "labels": tt})
    np.testing.assert_allclose(lt.item(), float(lj), atol=1e-5)


def test_unported_inputs_are_refused_by_name():
    """Image inputs and per-row caches, once refused by name, are ported:
    a config without image tokens ignores ``img_embeds`` and audio frames,
    which it does not read, as in the reference (the audio family is
    models/encdec.py); a per-row cache builds with (B, W) positions and
    decodes each row at its own position (tests/test_torch_queue.py holds
    it against the reference)."""
    cfg = smoke_config("smollm-135m")
    params = init_lm(prng.PRNGKey(0), cfg, device="cpu")
    api = get_api(cfg)
    tokens = torch.zeros(1, 4, dtype=torch.int64)
    imaged, _ = api.loss_fn(params, cfg, {"tokens": tokens, "labels": tokens,
                                          "img_embeds": torch.zeros(1, 2, cfg.d_model)})
    caches = api.init_cache_fn(params, cfg, 2, 8, torch.float32, per_row=True)
    assert tuple(caches["dense"]["positions"].shape) == (cfg.n_layers, 2, 8)
    _, caches = api.decode_fn(params, cfg, torch.zeros(2, 1, dtype=torch.int64),
                              torch.tensor([0, 5]), caches)
    assert caches["dense"]["positions"][:, 0, 0].eq(0).all()
    assert caches["dense"]["positions"][:, 1, 5].eq(5).all()
    plain, _ = api.loss_fn(params, cfg, {"tokens": tokens, "labels": tokens})
    assert torch.equal(plain, imaged)
    framed, _ = api.loss_fn(params, cfg, {"tokens": tokens, "labels": tokens,
                                          "frames": torch.zeros(1, 16, cfg.d_model)})
    assert torch.equal(plain, framed)


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels cannot run on the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_on_cuda_matches_cpu_and_launches_kernels(cuda_device, arch):
    """Loss with use_pallas at S=128 and a short generation on the card:
    every norm (2 per layer + qk-norms + the final one) and every attention
    of the loss go through the kernels, and agree with the CPU."""
    cfg = smoke_config(arch).replace(use_pallas=True)
    params = init_lm(prng.PRNGKey(1), cfg, device="cpu")
    params_gpu = tree_map(lambda t: t.to(cuda_device), params)
    _, tokens = _tokens(cfg, 2, 128, seed=9)
    norms = cfg.n_layers * (4 if cfg.qk_norm else 2) + 1
    reset_launches()
    l_gpu, _ = get_api(cfg).loss_fn(params_gpu, cfg, {"tokens": tokens.to(cuda_device),
                                                      "labels": tokens.to(cuda_device)})
    assert dict(LAUNCHES) == {"flash_attention": cfg.n_layers, "rmsnorm": norms}
    l_cpu, _ = get_api(cfg).loss_fn(params, cfg, {"tokens": tokens, "labels": tokens})
    assert abs(l_gpu.item() - l_cpu.item()) < 1e-4
    reset_launches()
    res_gpu = serve.generate(params_gpu, cfg, tokens[:, :16].to(cuda_device), 5)
    assert dict(LAUNCHES) == {"rmsnorm": 5 * norms}
    res_cpu = serve.generate(params, cfg, tokens[:, :16], 5)
    assert torch.equal(res_gpu.tokens.cpu(), res_cpu.tokens)
