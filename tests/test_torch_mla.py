"""The port's Multi-head Latent Attention (deepseek-v2-lite) against the JAX
package's ``models/attention.py`` MLA, on the smoke config (latent 32,
nope/rope/v heads 32/16/32).

The same key gives the same ``wq``, ``wkv_a``, ``kv_norm``, ``wkv_b`` and
``wo`` (init within 1e-6); from the same params and numpy inputs made from
a seed, the query split, the compression, the expansion, the attention,
the training and prefill forwards and the prefill cache agree within
1e-5, and three decode steps against the grown cache within 1e-5 with
``absorb`` False and True, each held against the reference's own setting;
the two settings agree within the reference's 2e-3. ``pad_cache`` grows the
compressed caches as the reference does; per-row decode is refused with
the reference's reason (GQA caches only). The ``cuda`` case runs on a card:

    python -m pytest -q -m cuda tests/test_torch_mla.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import get_api as jax_get_api
from repro.models.model import pad_cache as jax_pad_cache
from repro_torch import prng
from repro_torch.configs import smoke_config
from repro_torch.interop import lm_params_from_numpy, params_from_numpy, params_to_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import get_api, pad_cache
from repro_torch.tree import tree_map

ARCH = "deepseek-v2-lite-16b"
B, S, STEPS = 2, 12, 3
TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's worker processes share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(seed=0, **changes):
    """Both configs, the reference's and the port's params from one key,
    and numpy activations (B, S + STEPS, d) made from ``seed``."""
    jcfg = jax_smoke_config(ARCH).replace(**changes)
    cfg = smoke_config(ARCH).replace(**changes)
    jp = jattn.init_mla(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(seed).standard_normal((B, S + STEPS, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, tp, x


def _positions(n):
    p = np.broadcast_to(np.arange(n, dtype=np.int32), (B, n))
    return jnp.asarray(p), torch.from_numpy(p.copy())


def _grown_jax(cache, cfg):
    """One layer's prefill cache in a fresh cache of S + STEPS slots (the
    rest empty), the reference's."""
    grown = jattn.init_mla_cache(cfg, B, S + STEPS, jnp.float32)
    return {k: v.at[..., :S].set(cache[k]) if k == "positions" else v.at[:, :S].set(cache[k])
            for k, v in grown.items()}


def _grown(cache, cfg):
    """``_grown_jax`` in the port, on the cache's device."""
    grown = tattn.init_mla_cache(cfg, B, S + STEPS, torch.float32, cache["c_kv"].device)
    for k, v in grown.items():
        (v[..., :S] if k == "positions" else v[:, :S]).copy_(cache[k])
    return grown


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=0, err_msg=what)


def test_init_mla_matches_jax():
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    want = jax.tree.map(np.asarray, jattn.init_mla(jax.random.PRNGKey(5), jcfg))
    got = params_to_numpy(tattn.init_mla(prng.PRNGKey(5), cfg))
    assert set(got) == set(want) == {"wq", "wkv_a", "kv_norm", "wkv_b", "wo"}
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        _close(got[k], w, 1e-6, k)
    np.testing.assert_array_equal(got["kv_norm"], np.ones(cfg.kv_lora_rank, np.float32))
    assert got["wq"].shape == (cfg.d_model, cfg.n_heads * (32 + 16))
    assert got["wkv_b"].shape == (cfg.kv_lora_rank, cfg.n_heads * (32 + 32))


def test_mla_parts_match_jax():
    """``_mla_q``, ``_mla_compress``, ``_mla_expand`` and ``_mla_sdpa`` one
    by one, each on the reference's own inputs to it."""
    jcfg, cfg, jp, tp, x = _setup(1)
    pj, pt = _positions(S)
    xj, xt = jnp.asarray(x[:, :S]), torch.from_numpy(x[:, :S])
    qj, qt = jattn._mla_q(jp, jcfg, xj, pj), tattn._mla_q(tp, cfg, xt, pt)
    cj, ct = jattn._mla_compress(jp, jcfg, xj, pj), tattn._mla_compress(tp, cfg, xt, pt)
    for a, b, what in zip(qt + ct, qj + cj, ("qn", "qr", "c_kv", "k_rope")):
        assert tuple(a.shape) == b.shape, what
        _close(a, b, what=what)
    ej = jattn._mla_expand(jp, jcfg, cj[0])
    et = tattn._mla_expand(tp, cfg, torch.from_numpy(np.array(cj[0])))
    for a, b, what in zip(et, ej, ("k_nope", "v")):
        assert tuple(a.shape) == b.shape, what
        _close(a, b, what=what)
    oj = jattn._mla_sdpa(jcfg, *qj, ej[0], cj[1], ej[1], pj[0], pj[0])
    ot = tattn._mla_sdpa(cfg, *(torch.from_numpy(np.array(a)) for a in (*qj, ej[0], cj[1], ej[1])),
                         pt[0], pt[0])
    assert tuple(ot.shape) == (B, S, cfg.n_heads, cfg.v_head_dim)
    _close(ot, oj, what="sdpa")


def test_mla_train_and_prefill_match_jax():
    jcfg, cfg, jp, tp, x = _setup(2)
    pj, pt = _positions(S)
    xj, xt = jnp.asarray(x[:, :S]), torch.from_numpy(x[:, :S])
    _close(tattn.mla_train(tp, cfg, xt, pt), jattn.mla_train(jp, jcfg, xj, pj), what="train")
    yj, cj = jattn.mla_prefill(jp, jcfg, xj, pj)
    yt, ct = tattn.mla_prefill(tp, cfg, xt, pt)
    _close(yt, yj, what="prefill")
    assert set(ct) == set(cj) == {"c_kv", "k_rope", "positions"}
    for k in cj:
        assert tuple(ct[k].shape) == cj[k].shape, k
        _close(ct[k], cj[k], what=k)


@pytest.mark.parametrize("absorb", [False, True], ids=["expand", "absorb"])
def test_mla_decode_matches_jax(absorb):
    """Prefill S tokens, grow the cache by STEPS slots, then decode STEPS
    tokens: each step's output and the written cache against the
    reference's with the same ``absorb``."""
    jcfg, cfg, jp, tp, x = _setup(3)
    pj, pt = _positions(S)
    _, cj = jattn.mla_prefill(jp, jcfg, jnp.asarray(x[:, :S]), pj)
    _, ct = tattn.mla_prefill(tp, cfg, torch.from_numpy(x[:, :S]), pt)
    cj, ct = _grown_jax(cj, jcfg), _grown(ct, cfg)
    for t in range(S, S + STEPS):
        yj, cj = jattn.mla_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jnp.int32(t), cj,
                                  absorb=absorb)
        yt, ct = tattn.mla_decode(tp, cfg, torch.from_numpy(x[:, t:t + 1]), t, ct,
                                  absorb=absorb)
        _close(yt, yj, what=f"pos {t}")
    for k in cj:
        _close(ct[k], cj[k], what=k)
    np.testing.assert_array_equal(ct["positions"].numpy(), np.arange(S + STEPS))


def test_mla_absorbed_decode_agrees_with_expanded():
    """The two decode settings on the same cache, within the reference's
    own 2e-3 (tests/test_serve.py)."""
    _, cfg, _, tp, x = _setup(4)
    _, pt = _positions(S)
    _, c0 = tattn.mla_prefill(tp, cfg, torch.from_numpy(x[:, :S]), pt)
    caches = [_grown(c0, cfg) for _ in range(2)]
    for t in range(S, S + STEPS):
        xt = torch.from_numpy(x[:, t:t + 1])
        ya, caches[0] = tattn.mla_decode(tp, cfg, xt, t, caches[0], absorb=False)
        yb, caches[1] = tattn.mla_decode(tp, cfg, xt, t, caches[1], absorb=True)
        assert (ya - yb).abs().max().item() < 2e-3


def test_pad_cache_grows_mla_caches_as_jax():
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    jparams = jax.tree.map(np.asarray,
                           jax_get_api(jcfg).init_params(jax.random.PRNGKey(0), jcfg))
    params = lm_params_from_numpy(jparams, cfg, device="cpu")
    t = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, cfg.vocab_size))
    _, cj = jax_get_api(jcfg).prefill_fn(jparams, jcfg, {"tokens": jnp.asarray(t),
                                                         "labels": jnp.asarray(t)})
    tt = torch.from_numpy(t.astype(np.int64))
    _, ct = get_api(cfg).prefill_fn(params, cfg, {"tokens": tt, "labels": tt})
    assert set(ct) == set(cj) == {"dense", "moe"}
    gj, gt = jax_pad_cache(cj, S, S + 5), pad_cache(ct, S, S + 5)
    for stack in gj:
        assert set(gt[stack]) == {"c_kv", "k_rope", "positions"}
        for k in gj[stack]:
            assert tuple(gt[stack][k].shape) == gj[stack][k].shape, (stack, k)
            _close(gt[stack][k], gj[stack][k], what=f"{stack}/{k}")
        assert tuple(gt[stack]["c_kv"].shape)[2] == S + 5


def test_per_row_mla_decode_is_refused_naming_item_13():
    cfg = smoke_config(ARCH)
    params = get_api(cfg).init_params(prng.PRNGKey(0), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="per-row decode: GQA caches only"):
        get_api(cfg).init_cache_fn(params, cfg, B, 8, torch.float32, per_row=True)
    _, _, _, tp, x = _setup(0)
    cache = tattn.init_mla_cache(cfg, B, 8, torch.float32, "cpu")
    cache["positions"] = cache["positions"].expand(B, 8)
    with pytest.raises(NotImplementedError, match="per-row decode: GQA caches only"):
        tattn.mla_decode(tp, cfg, torch.from_numpy(x[:, :1]), 0, cache)


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("absorb", [False, True], ids=["expand", "absorb"])
def test_mla_decode_on_cuda_matches_cpu(absorb):
    """Prefill and decode on the card against the CPU within 1e-5; the
    ``kv_norm`` at the latent's width goes through the rmsnorm kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's rmsnorm kernel cannot run on the CPU")
    from repro_torch.kernels import LAUNCHES, reset_launches

    _, cfg, _, tp, x = _setup(6)
    dev = torch.device("cuda")
    tg = tree_map(lambda t: t.to(dev), tp)
    _, pt = _positions(S)
    outs = {}
    for where, p in (("cuda", tg), ("cpu", tp)):
        reset_launches()
        y, c = tattn.mla_prefill(p, cfg, torch.from_numpy(x[:, :S]).to(where), pt.to(where))
        c = _grown(c, cfg)
        ys = [y]
        for t in range(S, S + STEPS):
            y, c = tattn.mla_decode(p, cfg, torch.from_numpy(x[:, t:t + 1]).to(where), t, c,
                                    absorb=absorb)
            ys.append(y)
        outs[where] = ([y.cpu() for y in ys], dict(LAUNCHES))
    assert outs["cuda"][1] == {"rmsnorm": 1 + STEPS} and not outs["cpu"][1]
    for a, b in zip(outs["cuda"][0], outs["cpu"][0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
