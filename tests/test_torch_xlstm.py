"""The port's xLSTM blocks and LM against the JAX package's ``models/xlstm.py``
and ``models/xlstm_lm.py``, on the smoke config (d 128, 4 heads, mLSTM
d_inner 256, an sLSTM every 2 layers).

mLSTM and sLSTM from carried params: the forward, ``return_state`` (output
and state) and decode steps within 1e-4 (the logits gate: mLSTM divides by
a normaliser, a sum of signed q.k terms that can cancel down to its 1e-3
floor, and that amplifies f32 rounding; sLSTM's f32 states, up to about
40, within 1e-5 + 1e-6 relative). The LM: init within 1e-6, loss within
1e-5, prefill and decode logits within 1e-4 and identical greedy tokens,
with and without a tail of mLSTM layers and with several SSD chunks; a
prefill and then decode steps equal a longer prefill; loss gradients
within 1e-5 x max(1, max|g|) of ``jax.grad``. With a tail (an mLSTM layer
after the sLSTM) the reference's own gradients move by up to 2.6e-5 x
max|g| when its params move by one f32 rounding (1.2e-7 relative), so
there each leaf is held to twice that spread of the reference, measured
in the test. The reference's quirks hold in the port too: ``ff_gate``
equals ``ff_up``. The ``cuda`` case runs on a card:

    python -m pytest -q -m cuda tests/test_torch_xlstm.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import get_api as jax_get_api
from repro.models import xlstm as jx
from repro.models.model import pad_cache as jax_pad_cache
from repro_torch import prng, trips
from repro_torch.configs import smoke_config
from repro_torch.interop import lm_params_from_numpy, params_from_numpy, params_to_numpy
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.models import get_api, pad_cache
from repro_torch.models import xlstm as tx
from repro_torch.tree import tree_map

ARCH = "xlstm-1.3b"


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's worker processes share the CPU,
    where each process's full thread pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# config changes: the smoke config (1 group: 1 mLSTM + 1 sLSTM), a tail
# (1 group and 1 mLSTM after it), and chunks of 8 over a ragged length
VARIANTS = {"smoke": dict(), "tail": dict(n_layers=3), "chunks": dict(ssm_chunk=8)}


def _cfgs(**changes):
    return jax_smoke_config(ARCH).replace(**changes), smoke_config(ARCH).replace(**changes)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _x(cfg, B, L, seed=0):
    return np.random.default_rng(seed).standard_normal((B, L, cfg.d_model)).astype(np.float32)


def _close(got, want, atol, what="", rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=what)


# ------------------------------------------------------------------ blocks

@pytest.mark.parametrize("chunk", [256, 8])
def test_mlstm_forward_state_and_decode_match_jax(chunk):
    jcfg, cfg = _cfgs(ssm_chunk=chunk)
    jp = jx.init_mlstm(jax.random.PRNGKey(1), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = _x(cfg, 2, 20)
    _close(tx.mlstm_forward(tp, cfg, torch.from_numpy(x)).numpy(),
           jx.mlstm_forward(jp, jcfg, jnp.asarray(x)), 1e-4)
    yj, sj = jx.mlstm_forward(jp, jcfg, jnp.asarray(x[:, :16]), return_state=True)
    yt, st = tx.mlstm_forward(tp, cfg, torch.from_numpy(x[:, :16]), return_state=True)
    _close(yt.numpy(), yj, 1e-4)
    for k in ("state", "conv"):
        assert st[k].shape == sj[k].shape, k
        _close(st[k].numpy(), sj[k], 1e-5, k, rtol=1e-6)
    for t in range(16, 20):
        yj, sj = jx.mlstm_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]), sj)
        yt, st = tx.mlstm_decode(tp, cfg, torch.from_numpy(x[:, t:t + 1]), st)
        _close(yt.numpy(), yj, 1e-4, f"decode {t}")
    _close(st["state"].numpy(), sj["state"], 1e-5, rtol=1e-6)


def _owns_its_storage(t):
    return t.untyped_storage().nbytes() == t.numel() * t.element_size()


def test_mlstm_prefill_conv_cache_is_a_copy():
    """The conv cache of a prefill owns its ssm_conv rows: a view of the
    up-projection would hold the whole (B, L, 2 d_inner) product alive as
    long as the cache (every layer's, until the model stacks them)."""
    cfg = smoke_config(ARCH)
    p = tx.init_mlstm(prng.PRNGKey(1), cfg)
    _, st = tx.mlstm_forward(p, cfg, torch.from_numpy(_x(cfg, 2, 16)), return_state=True)
    assert st["conv"].shape == (2, cfg.ssm_conv, cfg.ssm_expand * cfg.d_model)
    assert _owns_its_storage(st["conv"])


def test_scan_runs_every_step_and_books_one_on_meta():
    """``trips.scan`` is the loop on a real tensor (each step booked
    once); on a meta one it traces one step under a trip factor of L, with
    the loop's output shapes."""
    def cell(x, w, h):
        seen.append(trips.factor())
        return (torch.tanh(x + h * w),)

    rng = np.random.default_rng(0)
    xs, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((2, 5, 3), (3,)))
    h, want = torch.zeros(2, 3), []
    for t in range(5):
        h = torch.tanh(xs[:, t] + h * w)
        want.append(h)
    for dev, factors in (("cpu", [1] * 5), ("meta", [5])):
        seen = []
        hs, (last,) = trips.scan(cell, xs.to(dev), (w.to(dev),), (torch.zeros(2, 3, device=dev),))
        assert hs.shape == (2, 5, 3) and last.shape == (2, 3) and seen == factors, dev
    hs, (last,) = trips.scan(cell, xs, (w,), (torch.zeros(2, 3),))
    assert torch.equal(hs, torch.stack(want, dim=1)) and torch.equal(last, want[-1])


def test_mlstm_cache_matches_jax():
    jcfg, cfg = _cfgs()
    want = jx.init_mlstm_cache(jcfg, 3, jnp.float32)
    got = tx.init_mlstm_cache(cfg, 3, torch.float32, "cpu")
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and not got[k].any(), k


def test_slstm_forward_state_and_decode_match_jax():
    jcfg, cfg = _cfgs()
    jp = jx.init_slstm(jax.random.PRNGKey(2), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = _x(cfg, 2, 12, seed=1)
    _close(tx.slstm_forward(tp, cfg, torch.from_numpy(x)).numpy(),
           jx.slstm_forward(jp, jcfg, jnp.asarray(x)), 1e-4)
    yj, sj = jx.slstm_forward(jp, jcfg, jnp.asarray(x[:, :8]), return_state=True)
    yt, st = tx.slstm_forward(tp, cfg, torch.from_numpy(x[:, :8]), return_state=True)
    _close(yt.numpy(), yj, 1e-4)
    for t in range(8, 12):
        yj, sj = jx.slstm_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]), sj)
        yt, st = tx.slstm_decode(tp, cfg, torch.from_numpy(x[:, t:t + 1]), st)
        _close(yt.numpy(), yj, 1e-4, f"decode {t}")
    for k in ("h", "c", "n", "m"):
        assert st[k].dtype == torch.float32, k
        _close(st[k].numpy(), sj[k], 1e-5, k, rtol=1e-6)


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_cell_inits_match_jax(cell):
    jcfg, cfg = _cfgs()
    want = _flat(jax.tree.map(np.asarray, getattr(jx, f"init_{cell}")(jax.random.PRNGKey(4), jcfg)))
    got = _flat(params_to_numpy(getattr(tx, f"init_{cell}")(prng.PRNGKey(4), cfg)))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        _close(got[k], w, 1e-6, k)
    if cell == "slstm":                        # one key draws both, as in the reference
        np.testing.assert_array_equal(got["/ff_gate"], got["/ff_up"])


# ------------------------------------------------------------------ the LM

def _carry(cfg, jcfg, seed=3):
    jparams = jax_get_api(jcfg).init_params(jax.random.PRNGKey(seed), jcfg)
    return jparams, lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _tokens(cfg, B, S, seed=0):
    t = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (B, S), 0, cfg.vocab_size))
    return jnp.asarray(t), torch.from_numpy(t.astype(np.int64))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_xlstm_lm_init_matches_jax(variant):
    jcfg, cfg = _cfgs(**VARIANTS[variant])
    want = _flat(jax.tree.map(np.asarray, jax_get_api(jcfg).init_params(jax.random.PRNGKey(7),
                                                                          jcfg)))
    got = _flat(params_to_numpy(get_api(cfg).init_params(prng.PRNGKey(7), cfg, device="cpu")))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        _close(got[k], w, 1e-6, k)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_xlstm_lm_loss_prefill_and_decode_match_jax(variant):
    jcfg, cfg = _cfgs(**VARIANTS[variant])
    jparams, params = _carry(cfg, jcfg)
    japi, api = jax_get_api(jcfg), get_api(cfg)
    B, P, steps = 2, 13, 3
    tj, tt = _tokens(cfg, B, P + steps)
    w = np.array([0.7, 0.3], np.float32)
    lj, mj = japi.loss_fn(jparams, jcfg, {"tokens": tj, "labels": tj,
                                          "client_weights": jnp.asarray(w)})
    lt, mt = api.loss_fn(params, cfg, {"tokens": tt, "labels": tt,
                                       "client_weights": torch.from_numpy(w)})
    assert mt == mj == {}
    _close(lt.item(), float(lj), 1e-5)
    gj, cj = japi.prefill_fn(jparams, jcfg, {"tokens": tj[:, :P], "labels": tj[:, :P]})
    gt, ct = api.prefill_fn(params, cfg, {"tokens": tt[:, :P], "labels": tt[:, :P]})
    assert gt.shape == gj.shape == (B, 1, cfg.padded_vocab)
    _close(gt.numpy(), gj, 1e-4)
    assert (ct["slstm"] is None) == (cj["slstm"] is None)
    cj, ct = jax_pad_cache(cj, P, P + steps), pad_cache(ct, P, P + steps)
    for t in range(P, P + steps):
        gj, cj = japi.decode_fn(jparams, jcfg, tj[:, t:t + 1], jnp.int32(t), cj)
        gt, ct = api.decode_fn(params, cfg, tt[:, t:t + 1], t, ct)
        _close(gt.numpy(), gj, 1e-4, f"pos {t}")
    _close(ct["mlstm"]["state"].numpy(), cj["mlstm"]["state"], 1e-4)


def test_xlstm_init_cache_matches_jax():
    jcfg, cfg = _cfgs(n_layers=3)
    jparams, params = _carry(cfg, jcfg)
    want = jax_get_api(jcfg).init_cache_fn(jparams, jcfg, 2, 8, jnp.float32)
    got = get_api(cfg).init_cache_fn(params, cfg, 2, 8, torch.float32)
    for k, w in _flat(jax.tree.map(np.asarray, want)).items():
        g = _flat(params_to_numpy(got))[k]
        assert g.shape == w.shape and g.dtype == w.dtype and not g.any(), k


def test_prefill_then_decode_equals_a_longer_prefill():
    _, cfg = _cfgs(n_layers=3, ssm_chunk=8)
    params = get_api(cfg).init_params(prng.PRNGKey(5), cfg, device="cpu")
    api = get_api(cfg)
    _, tt = _tokens(cfg, 2, 20, seed=2)
    _, caches = api.prefill_fn(params, cfg, {"tokens": tt[:, :15], "labels": tt[:, :15]})
    caches = pad_cache(caches, 15, 20)
    for t in range(15, 20):
        logits, caches = api.decode_fn(params, cfg, tt[:, t:t + 1], t, caches)
    want, _ = api.prefill_fn(params, cfg, {"tokens": tt, "labels": tt})
    _close(logits.numpy(), want.numpy(), 1e-4)


# the tail variant's gradient gate: draws of the reference's own spread,
# and the most that spread may be relative to max(1, max|g|) (the draws of
# seeds 0-5 reach 8.1e-5 at most, on the mLSTM conv bias after the sLSTM)
SPREAD_SEEDS, SPREAD_CEILING = 4, 1e-4


def _jax_grads(jcfg, jparams, tj):
    return jax.grad(lambda p: jax_get_api(jcfg).loss_fn(p, jcfg, {"tokens": tj,
                                                                  "labels": tj})[0])(jparams)


@pytest.mark.parametrize("variant", ["smoke", "tail"])
def test_xlstm_lm_gradients_match_jax(variant):
    """Every leaf within 1e-5 x max(1, max|g|); for the tail, within twice
    the reference's own spread where that is larger: the most the
    reference's gradients move over SPREAD_SEEDS draws of params moved by
    one f32 rounding (1.2e-7 relative). That spread must itself stay under
    SPREAD_CEILING x max(1, max|g|), so no draw can widen the gate past
    2 x SPREAD_CEILING."""
    jcfg, cfg = _cfgs(**VARIANTS[variant])
    jparams, params = _carry(cfg, jcfg, seed=6)
    tj, tt = _tokens(cfg, 2, 12, seed=3)
    want = _flat(jax.tree.map(np.asarray, _jax_grads(jcfg, jparams, tj)))
    spread = {k: 0.0 for k in want}
    for seed in range(SPREAD_SEEDS if variant == "tail" else 0):
        rng = np.random.default_rng(seed)
        moved = jax.tree.map(lambda a: jnp.asarray(np.asarray(a) * (
            1 + 1.2e-7 * rng.standard_normal(np.shape(a)).astype(np.float32))), jparams)
        for k, g in _flat(jax.tree.map(np.asarray, _jax_grads(jcfg, moved, tj))).items():
            spread[k] = max(spread[k], np.abs(g - want[k]).max())
    for k, s in spread.items():
        assert s <= SPREAD_CEILING * max(1.0, np.abs(want[k]).max()), (k, s)
    params = tree_map(lambda t: t.requires_grad_(True), params)
    loss, _ = get_api(cfg).loss_fn(params, cfg, {"tokens": tt, "labels": tt})
    loss.backward()
    got = _flat(tree_map(lambda t: t.grad.numpy(), params))
    for k, w in want.items():
        _close(got[k], w, max(1e-5 * max(1.0, np.abs(w).max()), 2 * spread[k]), k)


def test_remat_changes_no_gradient():
    _, cfg = _cfgs(n_layers=3, ssm_chunk=8)
    params = get_api(cfg).init_params(prng.PRNGKey(8), cfg, device="cpu")
    _, tt = _tokens(cfg, 2, 20, seed=4)
    grads = []
    for c in (cfg, cfg.replace(remat=True, ssm_checkpoint_chunks=False)):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
        get_api(c).loss_fn(p, c, {"tokens": tt, "labels": tt})[0].backward()
        grads.append(_flat(tree_map(lambda t: t.grad, p)))
    for k in grads[0]:
        _close(grads[1][k].numpy(), grads[0][k].numpy(), 1e-6, k)


def test_xlstm_on_cpu_counts_no_kernel():
    _, cfg = _cfgs()
    params = get_api(cfg).init_params(prng.PRNGKey(0), cfg, device="cpu")
    _, tt = _tokens(cfg, 1, 8)
    reset_launches()
    get_api(cfg).loss_fn(params, cfg, {"tokens": tt, "labels": tt})
    assert not LAUNCHES


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels cannot run on the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_xlstm_on_cuda_matches_cpu_and_launches_rmsnorm(cuda_device):
    """Every norm of the loss and of a decode step (2 per block + the
    final one) goes through the rmsnorm kernel; the loss and greedy tokens
    agree with the CPU."""
    from repro_torch.launch import serve

    _, cfg = _cfgs(n_layers=3, ssm_chunk=8)
    params = get_api(cfg).init_params(prng.PRNGKey(1), cfg, device="cpu")
    params_gpu = tree_map(lambda t: t.to(cuda_device), params)
    _, tt = _tokens(cfg, 2, 32, seed=9)
    norms = 2 * cfg.n_layers + 1
    reset_launches()
    with torch.no_grad():
        l_gpu, _ = get_api(cfg).loss_fn(params_gpu, cfg, {"tokens": tt.to(cuda_device),
                                                          "labels": tt.to(cuda_device)})
    assert dict(LAUNCHES) == {"rmsnorm": norms}
    l_cpu, _ = get_api(cfg).loss_fn(params, cfg, {"tokens": tt, "labels": tt})
    assert abs(l_gpu.item() - l_cpu.item()) < 1e-4
    reset_launches()
    res_gpu = serve.generate(params_gpu, cfg, tt[:, :16].to(cuda_device), 5)
    assert dict(LAUNCHES) == {"rmsnorm": 5 * norms}
    res_cpu = serve.generate(params, cfg, tt[:, :16], 5)
    assert torch.equal(res_gpu.tokens.cpu(), res_cpu.tokens)
