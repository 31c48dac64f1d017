"""The MoE (qwen2-moe-a2.7b), xLSTM (xlstm-1.3b), MLA (deepseek-v2-lite-16b)
and encoder-decoder (whisper-medium) families through the port's entry
points, against the JAX package.

Configs field for field; param trees, counts and active counts at full
width from shapes (the meta device against ``jax.eval_shape``);
``lm_params_from_numpy`` on both families' trees. The MoE LM on the smoke
config, and with ``first_dense_layers=1`` so that both stacks exist: init
within 1e-6, the loss with its load-balance term (aux weight 0.01) within
1e-5 and aux itself, prefill and decode logits within 1e-4, the
``use_pallas`` loss within 2e-4, gradients within 1e-5 x max(1, max|g|).
The serve CLI (``--preset tiny --device cpu``) gives the JAX serve loop's
greedy tokens for both families. deepseek-v2-lite (with ``mla_absorb``
off and on) and whisper through ``get_api`` on their smoke configs: init
within 1e-6, the loss with client weights within 1e-5 (and deepseek's
``use_pallas`` loss, which sends MLA to no kernel on either side), prefill
and three decode steps within 1e-4, and the serve CLI's greedy tokens
(whisper's frames drawn from the serve key). Their full-width trees are
the JAX package's, with 15,706,484,224 and 811,864,064 params, and
phi-3-vision's (the vlm family, tests/test_torch_vlm.py) with
3,822,259,200.
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
from repro.models.model import active_param_count as jax_active_param_count
from repro.models.model import pad_cache as jax_pad_cache
from repro_torch import prng
from repro_torch.configs import get_config, smoke_config
from repro_torch.interop import lm_params_from_numpy, params_to_numpy
from repro_torch.launch import serve
from repro_torch.models import active_param_count, get_api, pad_cache, param_count
from repro_torch.tree import tree_map

FAMILIES = ("qwen2-moe-a2.7b", "xlstm-1.3b")
MLA, AUDIO, VLM = "deepseek-v2-lite-16b", "whisper-medium", "phi-3-vision-4.2b"
# full-width param counts from the JAX package's init shapes
FULL_PARAMS = {MLA: 15_706_484_224, AUDIO: 811_864_064, VLM: 3_822_259_200}
# (arch, config changes) of the MLA and audio cases: deepseek decodes with
# the latent expanded and absorbed
NEW_CASES = {"mla_expand": (MLA, dict()), "mla_absorb": (MLA, dict(mla_absorb=True)),
             "whisper": (AUDIO, dict())}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's worker processes share the CPU,
    where each process's full thread pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MOE = "qwen2-moe-a2.7b"
# the MoE smoke config, and one with a dense first layer before two MoE ones
MOE_VARIANTS = {"smoke": dict(), "dense_first": dict(n_layers=3, first_dense_layers=1)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _cfgs(arch, **changes):
    return jax_smoke_config(arch).replace(**changes), smoke_config(arch).replace(**changes)


def _carry(cfg, jcfg, seed=3):
    jparams = jax_get_api(jcfg).init_params(jax.random.PRNGKey(seed), jcfg)
    return jparams, lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _tokens(cfg, B, S, seed=0):
    t = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (B, S), 0, cfg.vocab_size))
    return jnp.asarray(t), torch.from_numpy(t.astype(np.int64))


# ----------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", FAMILIES + (MLA, AUDIO))
def test_configs_match_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(smoke_config(arch)) == dataclasses.asdict(jax_smoke_config(arch))


@pytest.mark.parametrize("arch", FAMILIES + (MLA, AUDIO, VLM))
def test_full_width_tree_and_counts_match_jax(arch):
    """From shapes alone: the port's tree on the meta device against
    ``jax.eval_shape`` of the JAX init; param and active param counts."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    shapes = jax.eval_shape(lambda k: jax_get_api(jcfg).init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    meta = get_api(cfg).init_params(prng.PRNGKey(0), cfg, device="meta")
    want = {k: tuple(v.shape) for k, v in _flat(shapes).items()}
    assert {k: tuple(v.shape) for k, v in _flat(meta).items()} == want
    assert param_count(meta) == sum(int(np.prod(s)) for s in want.values())
    assert active_param_count(meta, cfg) == jax_active_param_count(shapes, jcfg)
    if arch in (MOE, MLA):
        assert active_param_count(meta, cfg) < param_count(meta)
    if arch in FULL_PARAMS:
        assert param_count(meta) == FULL_PARAMS[arch]


@pytest.mark.parametrize("variant", list(MOE_VARIANTS))
def test_active_param_count_matches_jax_on_smoke_trees(variant):
    jcfg, cfg = _cfgs(MOE, **MOE_VARIANTS[variant])
    jparams, params = _carry(cfg, jcfg)
    assert active_param_count(params, cfg) == jax_active_param_count(jparams, jcfg)


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b"])
def test_remaining_families_are_refused_by_name(arch):
    """Once refused naming ROADMAP item 10, phi-3-vision is ported: its
    config is the reference's, field for field, and it has an API."""
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(smoke_config(arch)) == dataclasses.asdict(jax_smoke_config(arch))
    assert get_api(get_config(arch)) is get_api(get_config("smollm-135m"))


# ----------------------------------------------------------------- interop

@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_params_from_numpy_carries_both_families(arch):
    jcfg, cfg = _cfgs(arch, **({"n_layers": 3} if arch != MOE else MOE_VARIANTS["dense_first"]))
    tree = jax.tree.map(np.asarray, jax_get_api(jcfg).init_params(jax.random.PRNGKey(2), jcfg))
    got = _flat(params_to_numpy(lm_params_from_numpy(tree, cfg, device="cpu")))
    assert set(got) == set(_flat(tree))
    for k, w in _flat(tree).items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    stack = "moe_layers" if arch == MOE else "slstm_layers"
    missing = {k: v for k, v in tree.items() if k != stack}
    with pytest.raises(ValueError, match="params"):
        lm_params_from_numpy(missing, cfg, device="cpu")


@pytest.mark.parametrize("arch", [MLA, AUDIO])
def test_lm_params_from_numpy_carries_mla_and_audio_trees(arch):
    """By key, the nested LayerNorm dicts ({"scale", "bias"}) included."""
    jcfg, cfg = _cfgs(arch)
    tree = jax.tree.map(np.asarray, jax_get_api(jcfg).init_params(jax.random.PRNGKey(2), jcfg))
    got = _flat(params_to_numpy(lm_params_from_numpy(tree, cfg, device="cpu")))
    assert set(got) == set(_flat(tree))
    assert ("/moe_layers/attn/kv_norm" in got) == (arch == MLA)
    assert ("/enc_layers/ln1/bias" in got) == (arch == AUDIO)
    for k, w in _flat(tree).items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    stack = "moe_layers" if arch == MLA else "enc_layers"
    missing = {k: v for k, v in tree.items() if k != stack}
    with pytest.raises(ValueError, match="params"):
        lm_params_from_numpy(missing, cfg, device="cpu")


# ----------------------------------------------------------------- the MoE LM

@pytest.mark.parametrize("variant", list(MOE_VARIANTS))
def test_moe_lm_init_matches_jax(variant):
    jcfg, cfg = _cfgs(MOE, **MOE_VARIANTS[variant])
    want = _flat(jax.tree.map(np.asarray,
                              jax_get_api(jcfg).init_params(jax.random.PRNGKey(7), jcfg)))
    got = _flat(params_to_numpy(get_api(cfg).init_params(prng.PRNGKey(7), cfg, device="cpu")))
    assert set(got) == set(want)
    assert ("/dense_layers/ln1" in got) == (variant == "dense_first")
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_allclose(got[k], w, atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("variant", list(MOE_VARIANTS))
def test_moe_lm_loss_prefill_and_decode_match_jax(variant):
    jcfg, cfg = _cfgs(MOE, **MOE_VARIANTS[variant])
    jparams, params = _carry(cfg, jcfg)
    japi, api = jax_get_api(jcfg), get_api(cfg)
    B, P, steps = 2, 16, 3
    tj, tt = _tokens(cfg, B, P + steps)
    w = np.array([0.4, 0.6], np.float32)
    lj, mj = japi.loss_fn(jparams, jcfg, {"tokens": tj, "labels": tj,
                                          "client_weights": jnp.asarray(w)})
    lt, mt = api.loss_fn(params, cfg, {"tokens": tt, "labels": tt,
                                       "client_weights": torch.from_numpy(w)})
    np.testing.assert_allclose(lt.item(), float(lj), atol=1e-5)
    np.testing.assert_allclose(float(mt["aux"]), float(mj["aux"]), atol=1e-5)
    assert float(mt["aux"]) > 0
    gj, cj = japi.prefill_fn(jparams, jcfg, {"tokens": tj[:, :P], "labels": tj[:, :P]})
    gt, ct = api.prefill_fn(params, cfg, {"tokens": tt[:, :P], "labels": tt[:, :P]})
    assert set(ct) == set(cj)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4)
    cj, ct = jax_pad_cache(cj, P, P + steps), pad_cache(ct, P, P + steps)
    for t in range(P, P + steps):
        gj, cj = japi.decode_fn(jparams, jcfg, tj[:, t:t + 1], jnp.int32(t), cj)
        gt, ct = api.decode_fn(params, cfg, tt[:, t:t + 1], t, ct)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4, err_msg=f"pos {t}")
    for stack in ct:
        np.testing.assert_array_equal(ct[stack]["positions"].numpy(),
                                      np.asarray(cj[stack]["positions"]))


def test_moe_init_cache_matches_jax():
    jcfg, cfg = _cfgs(MOE, **MOE_VARIANTS["dense_first"])
    jparams, params = _carry(cfg, jcfg)
    want = _flat(jax.tree.map(np.asarray,
                              jax_get_api(jcfg).init_cache_fn(jparams, jcfg, 2, 8, jnp.float32)))
    got = _flat(params_to_numpy(get_api(cfg).init_cache_fn(params, cfg, 2, 8, torch.float32)))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w.astype(got[k].dtype), err_msg=k)


def test_moe_use_pallas_loss_matches_jax():
    """S = 128 passes the ``S % 128 == 0`` gate: the flash path on both
    sides (the Pallas kernel in interpret mode, the port's plain version
    here), within 2e-4 of each other and of the port's chunked path."""
    jcfg, cfg = _cfgs(MOE)
    jparams, params = _carry(cfg, jcfg, seed=5)
    tj, tt = _tokens(cfg, 1, 128, seed=5)
    lj, _ = jax_get_api(jcfg).loss_fn(jparams, jcfg.replace(use_pallas=True),
                                      {"tokens": tj, "labels": tj})
    lt, _ = get_api(cfg).loss_fn(params, cfg.replace(use_pallas=True),
                                 {"tokens": tt, "labels": tt})
    lt_plain, _ = get_api(cfg).loss_fn(params, cfg, {"tokens": tt, "labels": tt})
    assert abs(lt.item() - float(lj)) < 2e-4
    assert abs(lt.item() - lt_plain.item()) < 2e-4


@pytest.mark.parametrize("variant", list(MOE_VARIANTS))
def test_moe_lm_gradients_match_jax(variant):
    jcfg, cfg = _cfgs(MOE, **MOE_VARIANTS[variant])
    jparams, params = _carry(cfg, jcfg, seed=6)
    tj, tt = _tokens(cfg, 2, 12, seed=3)
    gj = jax.grad(lambda p: jax_get_api(jcfg).loss_fn(p, jcfg, {"tokens": tj,
                                                                "labels": tj})[0])(jparams)
    params = tree_map(lambda t: t.requires_grad_(True), params)
    loss, _ = get_api(cfg).loss_fn(params, cfg, {"tokens": tt, "labels": tt})
    loss.backward()
    got = _flat(tree_map(lambda t: t.grad.numpy(), params))
    for k, w in _flat(jax.tree.map(np.asarray, gj)).items():
        np.testing.assert_allclose(got[k], w, atol=1e-5 * max(1.0, np.abs(w).max()), rtol=0,
                                   err_msg=k)


def test_pad_cache_leaves_xlstm_state_alone():
    _, cfg = _cfgs("xlstm-1.3b", slstm_every=0)
    params = get_api(cfg).init_params(prng.PRNGKey(1), cfg, device="cpu")
    c = get_api(cfg).init_cache_fn(params, cfg, 2, 8, torch.float32)
    assert c["slstm"] is None                 # no sLSTM group: the reference's None
    c2 = pad_cache(c, 8, 20)
    assert c2["slstm"] is None
    for k in ("state", "conv"):
        assert c2["mlstm"][k] is c["mlstm"][k]


# ----------------------------------------------------------------- MLA and audio

def _new_batch(cfg, B, S, seed=0):
    """Tokens from the JAX PRNG, and whisper's frames from numpy."""
    tj, tt = _tokens(cfg, B, S, seed)
    bj, bt = {"tokens": tj, "labels": tj}, {"tokens": tt, "labels": tt}
    if cfg.arch_type == "audio":
        f = (0.02 * np.random.default_rng(seed).standard_normal(
            (B, cfg.enc_frames, cfg.d_model))).astype(np.float32)
        bj["frames"], bt["frames"] = jnp.asarray(f), torch.from_numpy(f)
    return bj, bt


@pytest.mark.parametrize("arch", [MLA, AUDIO])
def test_mla_and_audio_init_matches_jax(arch):
    jcfg, cfg = _cfgs(arch)
    want = _flat(jax.tree.map(np.asarray,
                              jax_get_api(jcfg).init_params(jax.random.PRNGKey(7), jcfg)))
    got = _flat(params_to_numpy(get_api(cfg).init_params(prng.PRNGKey(7), cfg, device="cpu")))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_allclose(got[k], w, atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("case", list(NEW_CASES))
def test_mla_and_audio_loss_prefill_and_decode_match_jax(case):
    arch, changes = NEW_CASES[case]
    jcfg, cfg = _cfgs(arch, **changes)
    jparams, params = _carry(cfg, jcfg, seed=4)
    japi, api = jax_get_api(jcfg), get_api(cfg)
    B, P, steps = 2, 16, 3
    bj, bt = _new_batch(cfg, B, P + steps, seed=1)
    w = np.array([0.4, 0.6], np.float32)
    lj, mj = japi.loss_fn(jparams, jcfg, dict(bj, client_weights=jnp.asarray(w)))
    lt, mt = api.loss_fn(params, cfg, dict(bt, client_weights=torch.from_numpy(w)))
    np.testing.assert_allclose(lt.item(), float(lj), atol=1e-5)
    assert set(mt) == set(mj)
    if arch == MLA:
        np.testing.assert_allclose(float(mt["aux"]), float(mj["aux"]), atol=1e-5)
        lp, _ = api.loss_fn(params, cfg.replace(use_pallas=True), bt)
        ljp, _ = japi.loss_fn(jparams, jcfg.replace(use_pallas=True), bj)
        np.testing.assert_allclose(lp.item(), float(ljp), atol=1e-5)
    pj = dict(bj, tokens=bj["tokens"][:, :P], labels=bj["labels"][:, :P])
    pt = dict(bt, tokens=bt["tokens"][:, :P], labels=bt["labels"][:, :P])
    gj, cj = japi.prefill_fn(jparams, jcfg, pj)
    gt, ct = api.prefill_fn(params, cfg, pt)
    assert set(ct) == set(cj)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4)
    cj, ct = jax_pad_cache(cj, P, P + steps), pad_cache(ct, P, P + steps)
    for t in range(P, P + steps):
        gj, cj = japi.decode_fn(jparams, jcfg, bj["tokens"][:, t:t + 1], jnp.int32(t), cj)
        gt, ct = api.decode_fn(params, cfg, bt["tokens"][:, t:t + 1], t, ct)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4, err_msg=f"pos {t}")
    fj, ft = _flat(jax.tree.map(np.asarray, cj)), _flat(params_to_numpy(ct))
    assert set(ft) == set(fj)
    for k in fj:
        if k.endswith("positions"):
            np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)


# ----------------------------------------------------------------- serving

def _jax_serve_loop(cfg, seed, B, P, G):
    """The JAX package's launch/serve.py loop, without its printing."""
    cfg = cfg.replace(ssm_chunk=min(cfg.ssm_chunk, max(8, P // 2)))
    api = jax_get_api(cfg)
    key = jax.random.PRNGKey(seed)
    params = api.init_params(key, cfg)
    prompts = jax.random.randint(key, (B, P), 0, cfg.vocab_size)
    batch = {"tokens": prompts, "labels": prompts}
    if cfg.arch_type == "audio":
        batch["frames"] = 0.02 * jax.random.normal(key, (B, cfg.enc_frames, cfg.d_model))
    logits, caches = api.prefill_fn(params, cfg, batch)
    caches = jax_pad_cache(caches, P, P + G)
    tok = jnp.argmax(logits[:, -1:, :cfg.vocab_size], axis=-1)
    out = [tok]
    for step in range(G - 1):
        logits, caches = api.decode_fn(params, cfg, tok, jnp.int32(P + step), caches)
        tok = jnp.argmax(logits[:, -1:, :cfg.vocab_size], axis=-1)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch", FAMILIES + (MLA, AUDIO))
def test_serve_cli_matches_jax_serve_loop(arch, capsys):
    B, P, G = 2, 16, 6
    res = serve.main(["--arch", arch, "--preset", "tiny", "--device", "cpu", "--batch", str(B),
                      "--prompt-len", str(P), "--gen", str(G), "--seed", "2"])
    assert f"serving {arch}-smoke on cpu" in capsys.readouterr().out
    assert res.tokens.shape == (B, G)
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  _jax_serve_loop(jax_smoke_config(arch), 2, B, P, G))


def test_absorbed_mla_generate_matches_jax_serve_loop():
    """The serve launcher's weights, prompts and greedy loop with
    ``mla_absorb`` on: the JAX package's tokens."""
    B, P, G = 2, 16, 6
    jcfg, cfg = _cfgs(MLA, mla_absorb=True)
    key = prng.PRNGKey(2)
    params = get_api(cfg).init_params(key, cfg, device="cpu")
    prompts = prng.randint(key, (B, P), 0, cfg.vocab_size)
    res = serve.generate(params, cfg, prompts, G)
    np.testing.assert_array_equal(res.tokens.numpy(), _jax_serve_loop(jcfg, 2, B, P, G))
