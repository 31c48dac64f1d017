"""The port's MoE FFN against the JAX package's ``models/moe.py``.

The same key gives the same router, experts and shared experts (init
within 1e-6); the same params and inputs give the same output and
load-balance loss (1e-5) with and without shared experts, with
``norm_topk`` on and off, with padded (masked) experts, when capacity
drops tokens, at a decode-sized call (n = B) and over two dispatch groups.
The routing (each token's experts and every expert's nonzero-gate picks)
is identical, and gradients agree with ``jax.grad`` within 1e-5 x max(1,
max|g|). Two calls on one device are bit-equal. The ``cuda`` cases run on
a card:

    python -m pytest -q -m cuda tests/test_torch_moe.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models.moe import capacity as jax_capacity
from repro.models.moe import init_moe as jax_init_moe
from repro.models.moe import moe_ffn as jax_moe_ffn
from repro_torch import prng
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models.moe import capacity, init_moe, moe_ffn, moe_route
from repro_torch.tree import tree_map

ARCH = "qwen2-moe-a2.7b"


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's worker processes share the CPU,
    where each process's full thread pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# (config changes, B, S, groups): the smoke config (4 experts, top-2, one
# shared expert, norm_topk False) and its variants
CASES = {
    "smoke": (dict(), 2, 16, 1),
    "no_shared": (dict(n_shared_experts=0), 2, 16, 1),
    "norm_topk": (dict(norm_topk=True), 2, 16, 1),
    "padded_experts": (dict(pad_experts_to=6), 2, 16, 1),
    "capacity_drop": (dict(capacity_factor=0.25), 2, 16, 1),
    "decode_n_eq_b": (dict(), 4, 1, 1),
    "two_groups": (dict(top_k=1, n_experts=3), 2, 12, 2),
}


def _cfgs(changes):
    return jax_smoke_config(ARCH).replace(**changes), smoke_config(ARCH).replace(**changes)


def _setup(changes, B, S, seed=0):
    jcfg, cfg = _cfgs(changes)
    jp = jax_init_moe(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"), x


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("changes", [dict(), dict(n_shared_experts=0), dict(pad_experts_to=6)],
                         ids=["smoke", "no_shared", "padded"])
def test_init_moe_matches_jax(changes):
    jcfg, cfg = _cfgs(changes)
    want = _flat(jax.tree.map(np.asarray, jax_init_moe(jax.random.PRNGKey(5), jcfg)))
    got = _flat(params_to_numpy(init_moe(prng.PRNGKey(5), cfg)))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_allclose(got[k], w, atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("n", [1, 4, 7, 16, 64, 333])
@pytest.mark.parametrize("changes", [dict(), dict(capacity_factor=0.25), dict(top_k=1)],
                         ids=["smoke", "cf_0.25", "top1"])
def test_capacity_matches_jax(n, changes):
    jcfg, cfg = _cfgs(changes)
    assert capacity(n, cfg) == jax_capacity(n, jcfg)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_jax(case):
    changes, B, S, groups = CASES[case]
    jcfg, cfg, jp, tp, x = _setup(changes, B, S)
    yj, auxj = jax_moe_ffn(jp, jcfg, jnp.asarray(x), groups=groups)
    yt, auxt = moe_ffn(tp, cfg, torch.from_numpy(x), groups=groups)
    assert yt.shape == (B, S, cfg.d_model) and yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(auxt.item(), float(auxj), atol=1e-5, rtol=0)


def _jax_routing(p, cfg, xf):
    """The router and dispatch of the JAX package's ``moe_ffn``, step for
    step: (topi, w_sel, idx)."""
    E, k = cfg.padded_experts, cfg.top_k
    logits = xf.astype(jnp.float32) @ p["router"].astype(jnp.float32)
    if E > cfg.n_experts:
        logits = jnp.where((jnp.arange(E) >= cfg.n_experts)[None, None, :], -1e30, logits)
    probs = jax.nn.softmax(logits, axis=-1)
    topv, topi = jax.lax.top_k(probs, k)
    if cfg.norm_topk:
        topv = topv / jnp.maximum(topv.sum(-1, keepdims=True), 1e-9)
    gates = jnp.sum(jax.nn.one_hot(topi, E, dtype=jnp.float32) * topv[..., None], axis=2)
    w_sel, idx = jax.lax.top_k(gates.swapaxes(1, 2), jax_capacity(xf.shape[1], cfg))
    return np.asarray(topi), np.asarray(w_sel), np.asarray(idx)


@pytest.mark.parametrize("case", ["smoke", "capacity_drop", "padded_experts", "decode_n_eq_b"])
def test_routing_matches_jax(case):
    """Each token's experts, and each expert's picks with a nonzero gate,
    in the same order; the zero-gate picks (ties) take the lower token
    index on both sides."""
    changes, B, S, _ = CASES[case]
    jcfg, cfg, jp, tp, x = _setup(changes, B, S, seed=3)
    xf = x.reshape(1, B * S, cfg.d_model)
    topi_j, w_j, idx_j = _jax_routing(jp, jcfg, jnp.asarray(xf))
    _, topi_t, w_t, idx_t = moe_route(tp, cfg, torch.from_numpy(xf))
    np.testing.assert_array_equal(topi_t.numpy(), topi_j)
    np.testing.assert_array_equal(w_t.numpy() > 0, w_j > 0)
    np.testing.assert_array_equal(np.where(w_j > 0, idx_t.numpy(), -1),
                                  np.where(w_j > 0, idx_j, -1))
    np.testing.assert_allclose(w_t.numpy(), w_j, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    if case == "capacity_drop":
        chosen = np.bincount(topi_j.reshape(-1), minlength=cfg.n_experts)
        assert chosen.max() > idx_j.shape[-1], "no token dropped"


@pytest.mark.parametrize("case", ["smoke", "norm_topk", "capacity_drop", "padded_experts"])
def test_moe_ffn_gradients_match_jax(case):
    changes, B, S, groups = CASES[case]
    jcfg, cfg, jp, tp, x = _setup(changes, B, S, seed=1)
    r = np.random.default_rng(9).standard_normal((B, S, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        y, aux = jax_moe_ffn(p, jcfg, xx, groups=groups)
        return jnp.sum(y * r) + aux

    gp_j, gx_j = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    params = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe_ffn(params, cfg, xt, groups=groups)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    want = _flat(jax.tree.map(np.asarray, gp_j))
    got = _flat(tree_map(lambda t: t.grad.numpy(), params))
    want["x"], got["x"] = np.asarray(gx_j), xt.grad.numpy()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-5 * max(1.0, np.abs(w).max()), rtol=0,
                                   err_msg=k)


def test_moe_ffn_is_deterministic_on_the_cpu():
    changes, B, S, groups = CASES["capacity_drop"]
    _, cfg, _, tp, x = _setup(changes, B, S, seed=2)
    a, aux_a = moe_ffn(tp, cfg, torch.from_numpy(x), groups=groups)
    b, aux_b = moe_ffn(tp, cfg, torch.from_numpy(x), groups=groups)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's MoE path cannot run on the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["smoke", "capacity_drop", "padded_experts"])
def test_moe_ffn_on_cuda_is_deterministic_and_matches_cpu(cuda_device, case):
    """Two calls on the card are bit-equal (the combine adds one expert at a
    time, so no atomic add collides), and agree with the CPU within 1e-5
    with the same routing."""
    changes, B, S, groups = CASES[case]
    _, cfg, _, tp, x = _setup(changes, B, S, seed=4)
    tg = tree_map(lambda t: t.to(cuda_device), tp)
    xg = torch.from_numpy(x).to(cuda_device)
    a, aux_a = moe_ffn(tg, cfg, xg, groups=groups)
    b, aux_b = moe_ffn(tg, cfg, xg, groups=groups)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    c, aux_c = moe_ffn(tp, cfg, torch.from_numpy(x), groups=groups)
    np.testing.assert_allclose(a.cpu().numpy(), c.numpy(), atol=1e-5, rtol=0)
    assert abs(aux_a.item() - aux_c.item()) < 1e-5
    xf = torch.from_numpy(x).reshape(1, B * S, -1)
    _, topi_g, w_g, idx_g = moe_route(tg, cfg, xf.to(cuda_device))
    _, topi_c, w_c, idx_c = moe_route(tp, cfg, xf)
    assert torch.equal(topi_g.cpu(), topi_c)
    assert torch.equal(torch.where(w_g > 0, idx_g, -1).cpu(), torch.where(w_c > 0, idx_c, -1))
