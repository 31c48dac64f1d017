"""The port's whisper encoder-decoder against the JAX package's
``models/encdec.py``, its layer helpers and its cross-attention, on
whisper-medium's smoke config (2 encoder and 2 decoder layers over 16
frames).

The helpers from numpy inputs made from a seed: ``layer_norm`` (f32, the
two-pass variance), ``linear``, ``init_gelu_mlp`` (within 1e-6),
``gelu_mlp`` (GELU's tanh approximation), ``sinusoidal_positions``
(bit-equal: both build it in float64 numpy) and ``unembed`` within 1e-5;
``init_attention(cross=True)`` with its zero biases, ``cross_kv`` and
``cross_attn`` within 1e-5. The model: init within 1e-6, ``encode`` within
1e-5, the loss (whose mask also drops labels past the vocabulary) within
1e-5, prefill and three decode steps within 1e-4, and the caches. A
decode step's f32 position encoding at positions 0, 1 and 300 against the
reference's expression, tighter than the float64 table meets. ``pad_cache`` grows the cross K/V too where the
frame count equals the prompt length, as the reference's does. The
``cuda`` case runs on a card:

    python -m pytest -q -m cuda tests/test_torch_encdec.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models.model import pad_cache as jax_pad_cache
from repro_torch import prng
from repro_torch.configs import smoke_config
from repro_torch.interop import lm_params_from_numpy, params_from_numpy, params_to_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models import get_api, layers as tlayers, pad_cache
from repro_torch.tree import tree_map

ARCH = "whisper-medium"
B, S, STEPS = 2, 12, 3
TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's worker processes share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=0, err_msg=what)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _both(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _rng(seed):
    return np.random.default_rng(seed)


# ----------------------------------------------------------------- helpers

def test_layer_norm_and_linear_match_jax():
    rng = _rng(0)
    # rows with a large common offset: a one-pass variance would cancel
    xj, xt = _both(rng.standard_normal((3, 5, 64)) * 3.0 + 40.0)
    sj, st = _both(rng.standard_normal(64))
    bj, bt = _both(rng.standard_normal(64))
    _close(tlayers.layer_norm(xt, st, bt, 1e-5), jlayers.layer_norm(xj, sj, bj, 1e-5), what="ln")
    wj, wt = _both(rng.standard_normal((64, 24)))
    _close(tlayers.linear(xt, wt), jlayers.linear(xj, wj), 1e-4, "no bias")
    cj, ct = _both(rng.standard_normal(24))
    _close(tlayers.linear(xt, wt, ct), jlayers.linear(xj, wj, cj), 1e-4, "bias")


def test_gelu_mlp_matches_jax():
    want = jax.tree.map(np.asarray, jlayers.init_gelu_mlp(jax.random.PRNGKey(3), 32, 96,
                                                          jnp.float32))
    got = params_to_numpy(tlayers.init_gelu_mlp(prng.PRNGKey(3), 32, 96, torch.float32))
    assert set(got) == set(want) == {"fc1", "b1", "fc2", "b2"}
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        _close(got[k], w, 1e-6, k)
    rng = _rng(1)
    p = {k: rng.standard_normal(w.shape).astype(np.float32) for k, w in want.items()}
    xj, xt = _both(rng.standard_normal((2, 7, 32)) * 2.0)
    got = tlayers.gelu_mlp(params_from_numpy(p, device="cpu"), xt)
    _close(got, jlayers.gelu_mlp(jax.tree.map(jnp.asarray, p), xj), 1e-4, "gelu_mlp")


def test_sinusoidal_positions_and_unembed_match_jax():
    for n, d in ((16, 128), (1500, 1024), (3, 10)):
        np.testing.assert_array_equal(tlayers.sinusoidal_positions(n, d).numpy(),
                                      np.asarray(jlayers.sinusoidal_positions(n, d)))
    rng = _rng(2)
    tj, tt = _both(rng.standard_normal((50, 16)))
    hj, ht = _both(rng.standard_normal((16, 50)))
    xj, xt = _both(rng.standard_normal((2, 3, 16)))
    _close(tlayers.unembed({"tok": tt}, xt), jlayers.unembed({"tok": tj}, xj), what="tied")
    _close(tlayers.unembed({"tok": tt}, xt, ht), jlayers.unembed({"tok": tj}, xj, hj),
           what="head")


# ----------------------------------------------------------------- cross-attention

def _attn_params(seed=4):
    """init_attention(cross=True) of both sides from one key, then random
    biases (the init's are zero) for the forward checks."""
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    want = jax.tree.map(np.asarray, jattn.init_attention(jax.random.PRNGKey(seed), jcfg,
                                                         cross=True))
    got = params_to_numpy(tattn.init_attention(prng.PRNGKey(seed), cfg, cross=True))
    rng = _rng(seed)
    p = {k: (rng.standard_normal(w.shape).astype(np.float32) * 0.1 if k[0] == "b" else w)
         for k, w in want.items()}
    return jcfg, cfg, want, got, p


def test_init_attention_cross_has_zero_biases():
    _, cfg, want, got, _ = _attn_params()
    assert set(got) == set(want) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo"}
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        _close(got[k], w, 1e-6, k)
        if k.startswith("b"):
            assert not got[k].any(), k


def test_cross_kv_and_cross_attn_match_jax():
    jcfg, cfg, _, _, p = _attn_params(5)
    pj, pt = jax.tree.map(jnp.asarray, p), params_from_numpy(p, device="cpu")
    rng = _rng(5)
    ej, et = _both(rng.standard_normal((B, cfg.enc_frames, cfg.d_model)))
    kvj, kvt = jattn.cross_kv(pj, jcfg, ej), tattn.cross_kv(pt, cfg, et)
    for a, b, what in zip(kvt, kvj, "kv"):
        assert tuple(a.shape) == b.shape == (B, cfg.enc_frames, cfg.n_kv_heads, cfg.hd)
        _close(a, b, what=what)
    xj, xt = _both(rng.standard_normal((B, S, cfg.d_model)))
    _close(tattn.cross_attn(pt, cfg, xt, kvt), jattn.cross_attn(pj, jcfg, xj, kvj), what="attn")


# ----------------------------------------------------------------- the model

def _model(seed=7):
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    jp = jencdec.init_encdec(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _batch(cfg, seed, n):
    rng = _rng(seed)
    t = rng.integers(0, cfg.vocab_size, size=(B, n)).astype(np.int32)
    frames = (0.02 * rng.standard_normal((B, cfg.enc_frames, cfg.d_model))).astype(np.float32)
    bj = {"tokens": jnp.asarray(t), "labels": jnp.asarray(t), "frames": jnp.asarray(frames)}
    bt = {"tokens": torch.from_numpy(t.astype(np.int64)),
          "labels": torch.from_numpy(t.astype(np.int64)), "frames": torch.from_numpy(frames)}
    return bj, bt


def test_init_encdec_matches_jax():
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    want = _flat(jax.tree.map(np.asarray, jencdec.init_encdec(jax.random.PRNGKey(9), jcfg)))
    got = _flat(params_to_numpy(tencdec.init_encdec(prng.PRNGKey(9), cfg, device="cpu")))
    assert set(got) == set(want)
    assert "/dec_layers/ln_x/bias" in got and "/enc_norm/scale" in got
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        _close(got[k], w, 1e-6, k)


def test_encode_and_loss_match_jax():
    jcfg, cfg, jp, tp = _model()
    bj, bt = _batch(cfg, 1, S)
    _close(tencdec.encode(tp, cfg, bt["frames"]), jencdec.encode(jp, jcfg, bj["frames"]),
           what="encode")
    # a vocabulary of 500 in the same 512 padded rows: labels past it (and
    # negative ones) are masked out
    jcfg, cfg = jcfg.replace(vocab_size=500), cfg.replace(vocab_size=500)
    lab = np.asarray(bj["labels"]).copy()
    lab[0, :3] = [-1, cfg.vocab_size, cfg.padded_vocab - 1]
    w = np.array([0.3, 0.7], np.float32)
    lj, mj = jencdec.encdec_loss(jp, jcfg, dict(bj, labels=jnp.asarray(lab),
                                                client_weights=jnp.asarray(w)))
    lt, mt = tencdec.encdec_loss(tp, cfg, dict(bt, labels=torch.from_numpy(lab.astype(np.int64)),
                                               client_weights=torch.from_numpy(w)))
    assert np.isfinite(float(lj))
    assert mt == mj == {}
    assert abs(lt.item() - float(lj)) < 1e-5


def test_prefill_and_decode_match_jax():
    jcfg, cfg, jp, tp = _model(8)
    bj, bt = _batch(cfg, 2, S + STEPS)
    pj = dict(bj, tokens=bj["tokens"][:, :S], labels=bj["labels"][:, :S])
    pt = dict(bt, tokens=bt["tokens"][:, :S], labels=bt["labels"][:, :S])
    gj, cj = jencdec.encdec_prefill(jp, jcfg, pj)
    gt, ct = tencdec.encdec_prefill(tp, cfg, pt)
    _close(gt, gj, 1e-4, "prefill")
    fj, ft = _flat(jax.tree.map(np.asarray, cj)), _flat(params_to_numpy(ct))
    assert set(ft) == set(fj) == {"/self/k", "/self/v", "/self/positions", "/cross/k",
                                  "/cross/v"}
    for k in fj:
        assert ft[k].shape == fj[k].shape, k
        _close(ft[k], fj[k], what=k)
    cj, ct = jax_pad_cache(cj, S, S + STEPS), pad_cache(ct, S, S + STEPS)
    for t in range(S, S + STEPS):
        gj, cj = jencdec.encdec_decode(jp, jcfg, bj["tokens"][:, t:t + 1], jnp.int32(t), cj)
        gt, ct = tencdec.encdec_decode(tp, cfg, bt["tokens"][:, t:t + 1], t, ct)
        _close(gt, gj, 1e-4, f"pos {t}")
    np.testing.assert_array_equal(ct["self"]["positions"].numpy(),
                                  np.asarray(cj["self"]["positions"]))


def test_init_encdec_cache_matches_jax():
    jcfg, cfg, jp, tp = _model()
    want = _flat(jax.tree.map(np.asarray, jencdec.init_encdec_cache(jp, jcfg, B, 10,
                                                                    jnp.float32)))
    got = _flat(params_to_numpy(get_api(cfg).init_cache_fn(tp, cfg, B, 10, torch.float32)))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w.astype(got[k].dtype), err_msg=k)


def _jax_decode_positions(pos, d):
    """The position encoding of the reference's ``encdec_decode``, its
    expression as written there."""
    idx = jnp.arange(d)
    ang = jnp.int32(pos).astype(jnp.float32) / jnp.power(10_000.0, 2 * (idx // 2) / d)
    return jnp.where(idx % 2 == 0, jnp.sin(ang), jnp.cos(ang))


# |port - reference| at each position: exact at 0; at 300 the angle is
# ~300, where the two sides' f32 pow and sin differ by a few ulps
# (3.8e-6 measured at d 1024) while the float64 table, rounded once, is
# 1.5e-5 away
DECODE_PE_TOL = {0: 0.0, 1: 1e-7, 300: 5e-6}


@pytest.mark.parametrize("pos", sorted(DECODE_PE_TOL))
def test_decode_position_encoding_matches_jax(pos):
    """Computed in f32 at the position, as the reference computes it, and
    not read from the float64 table."""
    for d in (128, 1024):
        got = tencdec.decode_positions(pos, d, "cpu")
        want = np.asarray(_jax_decode_positions(pos, d))
        assert got.dtype == torch.float32
        _close(got, want, DECODE_PE_TOL[pos], f"d {d}")
    table = tlayers.sinusoidal_positions(pos + 1, 1024)[pos].numpy()
    assert pos < 300 or np.abs(table - want).max() > DECODE_PE_TOL[pos]


def test_pad_cache_grows_cross_kv_when_frames_equal_prompt():
    """The reference's quirk: a cross K/V whose frame count equals the
    prompt length grows with the self cache; the port grows it too."""
    jcfg, cfg, jp, tp = _model()
    P = cfg.enc_frames
    bj, bt = _batch(cfg, 3, P)
    _, cj = jencdec.encdec_prefill(jp, jcfg, bj)
    _, ct = tencdec.encdec_prefill(tp, cfg, bt)
    gj, gt = jax_pad_cache(cj, P, P + 4), pad_cache(ct, P, P + 4)
    for k, w in _flat(jax.tree.map(np.asarray, gj)).items():
        assert _flat(params_to_numpy(gt))[k].shape == w.shape, k
    assert gt["cross"]["k"].shape[2] == P + 4
    _, ct = tencdec.encdec_prefill(tp, cfg, dict(bt, tokens=bt["tokens"][:, :8],
                                                  labels=bt["labels"][:, :8]))
    assert pad_cache(ct, 8, 12)["cross"]["k"].shape[2] == cfg.enc_frames


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
def test_encdec_on_cuda_matches_cpu():
    """Prefill and three decode steps on the card against the CPU (1e-4),
    with no kernel launched: every norm is LayerNorm and every attention
    the chunked one, as in the reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import LAUNCHES, reset_launches

    _, cfg, _, tp = _model(10)
    _, bt = _batch(cfg, 4, S + STEPS)
    outs = {}
    for where in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(where), tp)
        b = {k: v.to(where) for k, v in bt.items()}
        reset_launches()
        g, c = tencdec.encdec_prefill(p, cfg, dict(b, tokens=b["tokens"][:, :S],
                                                   labels=b["labels"][:, :S]))
        c = pad_cache(c, S, S + STEPS)
        gs = [g.cpu()]
        for t in range(S, S + STEPS):
            g, c = tencdec.encdec_decode(p, cfg, b["tokens"][:, t:t + 1], t, c)
            gs.append(g.cpu())
        outs[where] = gs
        assert not LAUNCHES, dict(LAUNCHES)
    for a, b in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0)
