"""The port's optimizers against the JAX package's ``optim``.

The same numpy pytree of params and three steps of numpy gradients go
through ``repro.optim`` and ``repro_torch.optim``: AdamW (with and without
clipping, with weight decay and ``lr_scale``) and SGD (with and without
momentum) agree within 1e-6 relative after three steps, their states too,
and ``clip_by_global_norm`` within 1e-6. The tree's dict keys are inserted
out of sorted order, so a global norm summed in insertion order would
round differently from the reference's (``jax.tree.leaves`` sorts them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jax_adamw
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import sgd as jax_sgd
from repro_torch.interop import adamw_state_from_numpy, params_from_numpy, params_to_numpy
from repro_torch.optim import adamw, clip_by_global_norm, sgd
from repro_torch.tree import tree_leaves_sorted

STEPS = 3


def _tree(rng, scale=1.0):
    """A params-like pytree, keys deliberately out of sorted order."""
    def a(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return {"z_head": a(6, 5), "emb": {"tok": a(7, 6)},
            "layers": [{"w": a(6, 6), "b": a(6)}, {"w": a(6, 6), "b": a(6)}], "a_norm": a(6)}


def _flat(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _close(got, want, rtol=1e-6):
    for g, w in zip(_flat(got), _flat(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * max(1.0, np.abs(w).max()))


def _run_both(jax_opt, torch_opt, lr_scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    p0 = _tree(rng)
    grads = [_tree(rng, 3.0) for _ in range(STEPS)]
    jp, js = jax.tree.map(jnp.asarray, p0), None
    tp, ts = params_from_numpy(p0, device="cpu"), None
    js, ts = jax_opt.init(jp), torch_opt.init(tp)
    for g in grads:
        jp, js = jax_opt.update(jp, jax.tree.map(jnp.asarray, g), js, lr_scale=lr_scale)
        tp, ts = torch_opt.update(tp, params_from_numpy(g, device="cpu"), ts,
                                  lr_scale=lr_scale)
    return (params_to_numpy(tp), params_to_numpy(ts)), (jp, js)


@pytest.mark.parametrize("kw,lr_scale", [
    (dict(lr=3e-3), 1.0),
    (dict(lr=3e-3, max_grad_norm=1.0), 1.0),            # clipping active (|g| ~ 40)
    (dict(lr=1e-2, weight_decay=0.1, b2=0.999), 0.5),
    (dict(lr=3e-3, max_grad_norm=1e3, weight_decay=0.0), 1.0),   # clip inactive
], ids=["plain", "clipped", "wd_lr_scale", "clip_inactive"])
def test_adamw_three_steps_match_jax(kw, lr_scale):
    (tp, ts), (jp, js) = _run_both(jax_adamw(**kw), adamw(**kw), lr_scale)
    _close(tp, jp)
    _close(ts["mu"], js["mu"])
    _close(ts["nu"], js["nu"])
    assert ts["count"].dtype == np.int32 and int(ts["count"]) == int(js["count"]) == STEPS


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_three_steps_match_jax(momentum):
    (tp, ts), (jp, js) = _run_both(jax_sgd(lr=0.05, momentum=momentum),
                                   sgd(lr=0.05, momentum=momentum), lr_scale=0.7)
    _close(tp, jp)
    if momentum:
        _close(ts["vel"], js["vel"])
    else:
        assert ts == {} and js == {}


@pytest.mark.parametrize("max_norm", [0.5, 1e4])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(np.random.default_rng(3), 2.0)
    jg, jn = jax_clip(jax.tree.map(jnp.asarray, g), max_norm)
    tg, tn = clip_by_global_norm(params_from_numpy(g, device="cpu"), max_norm)
    _close(params_to_numpy(tg), jg)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)


def test_sorted_leaves_are_jax_leaves():
    g = _tree(np.random.default_rng(4))
    got = [np.asarray(t) for t in tree_leaves_sorted(params_from_numpy(g, device="cpu"))]
    want = _flat(g)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_adamw_state_carried_from_jax_continues_the_same():
    """One JAX step, the state carried across with
    ``interop.adamw_state_from_numpy``, then two more steps on each side."""
    rng = np.random.default_rng(5)
    p0, grads = _tree(rng), [_tree(rng) for _ in range(3)]
    jopt, topt = jax_adamw(lr=3e-3, max_grad_norm=1.0), adamw(lr=3e-3, max_grad_norm=1.0)
    jp = jax.tree.map(jnp.asarray, p0)
    jp, js = jopt.update(jp, jax.tree.map(jnp.asarray, grads[0]), jopt.init(jp))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    ts = adamw_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    assert ts["count"].dtype == torch.int32 and ts["mu"]["emb"]["tok"].dtype == torch.float32
    for g in grads[1:]:
        jp, js = jopt.update(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = topt.update(tp, params_from_numpy(g, device="cpu"), ts)
    _close(params_to_numpy(tp), jp)
    _close(params_to_numpy(ts["nu"]), js["nu"])


def test_adamw_keeps_f32_moments_for_bf16_params():
    opt = adamw(lr=0.01)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state["mu"]["w"].dtype == torch.float32 and state["count"].dtype == torch.int32
    new, state = opt.update(params, {"w": torch.ones(4, dtype=torch.bfloat16)}, state)
    assert new["w"].dtype == torch.bfloat16 and state["nu"]["w"].dtype == torch.float32
    assert int(state["count"]) == 1
