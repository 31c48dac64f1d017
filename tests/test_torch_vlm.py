"""The vlm family (phi-3-vision-4.2b) through the port's entry points,
against the JAX package, on the smoke config (2 layers, d_model 128, 4
heads of 32, 8 image tokens).

Configs field for field and the full-width tree and count
(tests/test_torch_lm_families.py); from the same key the same model (init
within 1e-6); with random image embeddings ahead of the text the loss
within 1e-5, and 0 on both sides where the text is empty (seq ==
n_img_tokens); prefill and decode logits within 1e-4 (decode positions
start after the image slots); the serve CLI's greedy tokens; gradients
within 1e-5 x max(1, max|g|). At phi-3's head dim, 96 (a smoke variant of
d_model 192 with 2 heads of 96, 8 image + 120 text tokens so that S % 128
== 0), the ``use_pallas`` loss takes the flash attention path on both
sides (the Pallas kernel in interpret mode there, the plain version here)
and agrees within 2e-4. ``assemble_batch`` and ``arch_features`` give the
reference's batch, and whole ``run_scenario`` runs of phi-3 beside
smollm-135m as two ``arch`` tasks (sync tau 1: the fused AdamW step; tau 2
on ``vmap``: the fold; async fedadam) give the reference's traces within
the gates of tests/test_torch_train.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.launch.train as jtrain
import repro_torch.api as tapi
import repro_torch.launch.train as ttrain
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import get_api as jax_get_api
from repro.models.model import pad_cache as jax_pad_cache
from repro_torch import prng
from repro_torch.configs import get_config, smoke_config
from repro_torch.interop import lm_params_from_numpy, params_to_numpy
from repro_torch.launch import serve
from repro_torch.models import get_api, pad_cache

ARCH = "phi-3-vision-4.2b"
# phi-3's head dim at smoke width: d_model 192 = 2 heads of 96
HD96 = dict(d_model=192, n_heads=2, n_kv_heads=2, head_dim=96)
EVENTS = ("time", "versions", "arrivals", "buffer_sizes", "staleness_mean", "dropped",
          "cost_dropouts")
ADAM_SHARE = 1e-3           # at most this share of elements beyond 1e-4 (AdamW's first step)
RUNS = [dict(), dict(tau=2, backend="vmap"), dict(mode="async", aggregator="fedadam")]
RUN_IDS = ["sync_fused_adamw", "sync_tau2_vmap", "async_fedadam"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's worker processes share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _cfgs(**changes):
    return jax_smoke_config(ARCH).replace(**changes), smoke_config(ARCH).replace(**changes)


def _carry(jcfg, cfg, seed=3):
    jparams = jax_get_api(jcfg).init_params(jax.random.PRNGKey(seed), jcfg)
    return jparams, lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _batch(cfg, B, S, seed=0, weights=False):
    """Text of S tokens after random image embeddings (B, n_img, d), as
    numpy drawn from ``seed``: (JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    img = rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    bj = {"tokens": jnp.asarray(t), "labels": jnp.asarray(t), "img_embeds": jnp.asarray(img)}
    tt = torch.from_numpy(t.astype(np.int64))
    bt = {"tokens": tt, "labels": tt, "img_embeds": torch.from_numpy(img)}
    if weights:
        w = rng.random(B).astype(np.float32)
        bj["client_weights"], bt["client_weights"] = jnp.asarray(w), torch.from_numpy(w)
    return bj, bt


# ----------------------------------------------------------------- model

def test_configs_match_jax():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jax_get_config(ARCH))
    assert dataclasses.asdict(smoke_config(ARCH)) == dataclasses.asdict(jax_smoke_config(ARCH))
    assert smoke_config(ARCH).n_img_tokens == 8 and get_config(ARCH).hd == 96


def test_init_matches_jax():
    jcfg, cfg = _cfgs()
    want = _flat(jax.tree.map(np.asarray, jax_get_api(jcfg).init_params(jax.random.PRNGKey(7),
                                                                          jcfg)))
    got = _flat(get_api(cfg).init_params(prng.PRNGKey(7), cfg, device="cpu"))
    assert set(got) == set(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        np.testing.assert_allclose(got[name].numpy(), w, atol=1e-6, rtol=0, err_msg=name)


@pytest.mark.parametrize("S,weights", [(12, False), (12, True), (0, False), (1, True)],
                         ids=["text12", "text12_weighted", "text_empty", "text1_weighted"])
def test_loss_matches_jax(S, weights):
    """S text tokens after the image; with none the loss is 0 on both
    sides, since the image positions carry no label."""
    jcfg, cfg = _cfgs()
    jparams, params = _carry(jcfg, cfg)
    bj, bt = _batch(cfg, 2, S, seed=S, weights=weights)
    lj, _ = jax_get_api(jcfg).loss_fn(jparams, jcfg, bj)
    lt, metrics = get_api(cfg).loss_fn(params, cfg, bt)
    assert metrics == {"aux": 0.0}
    np.testing.assert_allclose(lt.item(), float(lj), atol=1e-5)
    if S == 0:
        assert lt.item() == float(lj) == 0.0


def test_image_embeds_move_the_loss():
    """The image embeddings are read: other embeddings, another loss."""
    _, cfg = _cfgs()
    params = get_api(cfg).init_params(prng.PRNGKey(1), cfg, device="cpu")
    _, bt = _batch(cfg, 2, 6)
    zeros = dict(bt, img_embeds=torch.zeros_like(bt["img_embeds"]))
    l1, _ = get_api(cfg).loss_fn(params, cfg, bt)
    l0, _ = get_api(cfg).loss_fn(params, cfg, zeros)
    assert abs(l1.item() - l0.item()) > 1e-4


def test_prefill_and_decode_match_jax():
    jcfg, cfg = _cfgs()
    jparams, params = _carry(jcfg, cfg, seed=4)
    B, P, steps, off = 2, 10, 3, cfg.n_img_tokens
    bj, bt = _batch(cfg, B, P + steps, seed=5)
    pj = dict(bj, tokens=bj["tokens"][:, :P], labels=bj["labels"][:, :P])
    pt = dict(bt, tokens=bt["tokens"][:, :P], labels=bt["labels"][:, :P])
    gj, cj = jax_get_api(jcfg).prefill_fn(jparams, jcfg, pj)
    gt, ct = get_api(cfg).prefill_fn(params, cfg, pt)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4)
    assert ct["dense"]["k"].shape[2] == P + off
    cj, ct = jax_pad_cache(cj, P + off, P + off + steps), pad_cache(ct, P + off, P + off + steps)
    for i, t in enumerate(range(P, P + steps)):
        gj, cj = jax_get_api(jcfg).decode_fn(jparams, jcfg, bj["tokens"][:, t:t + 1],
                                             jnp.int32(P + off + i), cj)
        gt, ct = get_api(cfg).decode_fn(params, cfg, bt["tokens"][:, t:t + 1], P + off + i, ct)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4, err_msg=f"step {i}")
    np.testing.assert_array_equal(ct["dense"]["positions"].numpy(),
                                  np.asarray(cj["dense"]["positions"]))


def _jax_serve_loop(cfg, seed, B, P, G):
    """The JAX package's launch/serve.py loop for a vlm, without printing."""
    api = jax_get_api(cfg)
    key = jax.random.PRNGKey(seed)
    params = api.init_params(key, cfg)
    off = cfg.n_img_tokens
    prompts = jax.random.randint(key, (B, P), 0, cfg.vocab_size)
    batch = {"tokens": prompts, "labels": prompts,
             "img_embeds": jnp.zeros((B, off, cfg.d_model))}
    logits, caches = api.prefill_fn(params, cfg, batch)
    caches = jax_pad_cache(caches, P + off, P + off + G)
    tok = jnp.argmax(logits[:, -1:, :cfg.vocab_size], axis=-1)
    out = [tok]
    for step in range(G - 1):
        logits, caches = api.decode_fn(params, cfg, tok, jnp.int32(P + off + step), caches)
        tok = jnp.argmax(logits[:, -1:, :cfg.vocab_size], axis=-1)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


def test_serve_cli_matches_jax_serve_loop(capsys):
    B, P, G = 2, 12, 6
    res = serve.main(["--arch", ARCH, "--preset", "tiny", "--device", "cpu", "--batch", str(B),
                      "--prompt-len", str(P), "--gen", str(G), "--seed", "2"])
    assert f"serving {ARCH}-smoke on cpu" in capsys.readouterr().out
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  _jax_serve_loop(jax_smoke_config(ARCH), 2, B, P, G))


def test_serve_features_are_zero_images():
    cfg = smoke_config(ARCH)
    feats = serve.serve_features(prng.PRNGKey(0), cfg, 3)
    assert set(feats) == {"img_embeds"} and serve.image_offset(cfg, feats) == cfg.n_img_tokens
    assert feats["img_embeds"].shape == (3, cfg.n_img_tokens, cfg.d_model)
    assert not feats["img_embeds"].any()
    assert serve.image_offset(cfg, {}) == 0       # text alone: no image slots
    assert serve.image_offset(smoke_config("smollm-135m"), {}) == 0


def test_gradients_match_jax():
    jcfg, cfg = _cfgs()
    jparams, params = _carry(jcfg, cfg, seed=6)
    bj, bt = _batch(cfg, 2, 12, seed=3, weights=True)
    gj = jax.grad(lambda p: jax_get_api(jcfg).loss_fn(p, jcfg, bj)[0])(jparams)
    _, gt = ttrain.loss_and_grads(get_api(cfg), cfg, params, bt)
    got = _flat(jax.tree.map(lambda t: t.numpy(), gt, is_leaf=torch.is_tensor))
    want = _flat(jax.tree.map(np.asarray, gj))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-5 * max(1.0, np.abs(w).max()), rtol=0,
                                   err_msg=k)


def test_use_pallas_loss_at_head_dim_96_matches_jax():
    """8 image + 120 text tokens: S = 128 passes the ``S % 128 == 0`` gate,
    so both sides take the flash path at hd 96."""
    jcfg, cfg = _cfgs(**HD96)
    assert cfg.hd == 96
    jparams, params = _carry(jcfg, cfg, seed=8)
    bj, bt = _batch(cfg, 1, 120, seed=8)
    pallas_j, pallas_t = jcfg.replace(use_pallas=True), cfg.replace(use_pallas=True)
    lj, _ = jax_get_api(jcfg).loss_fn(jparams, pallas_j, bj)
    lt, _ = get_api(cfg).loss_fn(params, pallas_t, bt)
    lt_plain, _ = get_api(cfg).loss_fn(params, cfg, bt)
    assert abs(lt.item() - float(lj)) < 2e-4
    assert abs(lt.item() - lt_plain.item()) < 2e-4


# ----------------------------------------------------------------- training

@pytest.mark.parametrize("seq", [32, 8, 5])
def test_arch_features_match_reference(seq):
    """The text is ``toks[..., :seq - n_img_tokens]``: 24 tokens at seq 32,
    none at seq == n_img_tokens (8), and at seq 5 the negative slice end
    keeps 2 * 5 - 8 = 2 tokens."""
    cfg, jcfg = smoke_config(ARCH), jax_smoke_config(ARCH)
    toks = np.random.default_rng(seq).integers(0, cfg.vocab_size, (3, seq)).astype(np.int32)
    want = jtrain.arch_features(jcfg, jnp.asarray(toks))
    got = ttrain.arch_features(cfg, torch.from_numpy(toks.astype(np.int64)))
    assert set(got) == set(want) == {"tokens", "labels", "img_embeds"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_assemble_batch_is_bit_equal():
    jt = jtrain.build_task(ARCH, "tiny", 32, 4)
    tt = ttrain.build_task(ARCH, "tiny", 32, 4, device="cpu")
    data = jtrain.make_dataset(None, jt["cfg"], 6, 4, 32, seed=2)
    w = np.random.default_rng(0).random(2).astype(np.float32)
    rj, rt = np.random.default_rng(7), np.random.default_rng(7)
    jb = jtrain.assemble_batch(jt, data, np.asarray([1, 4]), w, rj)
    tb = ttrain.assemble_batch(tt, data, np.asarray([1, 4]), w, rt)
    assert set(tb) == set(jb) == {"tokens", "labels", "client_weights", "img_embeds"}
    for k in jb:
        assert tuple(tb[k].shape) == jb[k].shape, k
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
    assert tb["tokens"].shape == (4, 32 - jt["cfg"].n_img_tokens)
    assert rt.bit_generator.state == rj.bit_generator.state


def _spec(api, *, tau=1, backend="serial", mode="sync", aggregator=None):
    return api.ScenarioSpec(
        name="vlm-beside-dense", seed=0, data_seed=0,
        tasks=[api.TaskSpec(a, family="arch",
                            options={"preset": "tiny", "seq": 32, "batch": 4, "tau": tau})
               for a in (ARCH, "smollm-135m")],
        clients=api.ClientPopulationSpec(n_clients=6, participation=0.5),
        allocation=api.AllocationSpec(strategy="fedfair", alpha=3.0),
        runtime=api.RuntimeSpec(mode=mode, backend=backend, rounds=2, tau=tau,
                                total_arrivals=8, buffer_size=2, aggregator=aggregator,
                                aggregator_options={"lr": 0.1} if aggregator else {}))


@functools.lru_cache(maxsize=None)
def _reference_run(**kw):
    return japi.run_scenario(_spec(japi, **kw))


@pytest.mark.parametrize("kw", RUNS, ids=RUN_IDS)
def test_runs_match_reference(kw):
    rt = tapi.run_scenario(_spec(tapi, **kw), device="cpu")
    rj = _reference_run(**kw)
    assert rt.mode == rj.mode == kw.get("mode", "sync")
    if rt.mode == "sync":
        np.testing.assert_array_equal(rt.alloc, rj.alloc)
        np.testing.assert_array_equal(rt.alloc_counts, rj.alloc_counts)
        assert rt.alloc_counts[:, 0].sum() > 0
    else:
        for key in EVENTS:
            np.testing.assert_array_equal(getattr(rt, key), getattr(rj, key), err_msg=key)
        assert rt.assignments == rj.assignments
    np.testing.assert_allclose(rt.loss, rj.loss, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(rt.acc, rj.acc)
    assert rt.task_names == rj.task_names == [ARCH, "smollm-135m"]
    max_share = ADAM_SHARE if rt.mode == "sync" and kw.get("tau", 1) <= 1 else 0.0
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
