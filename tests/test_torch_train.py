"""LM training through both ``run_scenario``s: the ``arch`` task family.

The same numpy inputs go to the JAX package's ``launch/train.py`` (and
``jax.grad``) and to the port's: the data shards and round batches
bit-equal; ``build_task``'s init within the LM init gate of 1e-6; the
loss gradients of the four smoke configs per leaf within 1e-5 x max(1,
max|g|); ``arch_local_fn`` (tau 2) and two ``arch_fused_step``s within
1e-5 in the params. The RMSNorm autograd Function passes
``torch.autograd.gradcheck`` in f64 and agrees with autograd through the
plain norm. Whole runs (the tiny two-task spec as it is, with tau 2 on
``vmap`` under fedadam, and async with fedavg and fedadam) give identical
allocation or event traces, losses and params within 1e-4 and identical
accuracy curves. One gate is missed by design and reported: AdamW's first
step (eps 1e-8) magnifies rounding-sized gradient differences at elements
whose gradient is below 1e-6, so there the params move by up to about
2e-4; ``test_arch_fused_step_two_steps_match_jax`` shows that every
element beyond the gate is such an element, and the runs that take the
fused AdamW step bound their share. The ``cuda`` cases run on a card:

    python -m pytest -q -m cuda tests/test_torch_train.py
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.launch.train as jtrain
import repro_torch.api as tapi
import repro_torch.launch.train as ttrain
from repro.configs import smoke_config as jax_smoke_config
from repro.models import get_api as jax_get_api
from repro_torch import prng
from repro_torch.configs import smoke_config
from repro_torch.interop import adamw_state_from_numpy, lm_params_from_numpy, params_to_numpy
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.ref import ref_rmsnorm
from repro_torch.kernels.rmsnorm import rmsnorm_trainable
from repro_torch.models import get_api
from repro_torch.tree import tree_map

ROOT = Path(__file__).resolve().parents[1]
SPEC = str(ROOT / "examples" / "specs" / "tiny_two_task.json")
ARCHS = ("smollm-135m", "qwen3-0.6b", "qwen1.5-0.5b", "zamba2-7b")
EVENTS = ("time", "versions", "arrivals", "buffer_sizes", "staleness_mean", "dropped",
          "cost_dropouts")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree)}


def _assert_trees_close(got, want, atol, max_share=0.0):
    """Every leaf of the port's tree within ``atol`` of the reference's;
    with ``max_share`` at most that share of all elements may exceed it
    (the AdamW first step, see ``test_arch_fused_step_two_steps_match_jax``)."""
    g = _flat(params_to_numpy(got))
    w = _flat(jax.tree.map(np.asarray, want))
    assert set(g) == set(w)
    beyond = 0
    for k in w:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
        if max_share:
            beyond += int((np.abs(g[k] - w[k]) > atol).sum())
        else:
            np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=0, err_msg=k)
    assert beyond <= max_share * sum(v.size for v in w.values()), beyond


def _carry(arch, seed=3):
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    jparams = jax_get_api(jcfg).init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jparams, cfg, lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                                    device="cpu")


def _batch(cfg, B, S, seed=0, weights=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    w = rng.random(B).astype(np.float32)
    w = (w / w.sum()).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks.astype(np.int64)),
          "labels": torch.from_numpy(toks.astype(np.int64))}
    if weights:
        jb["client_weights"] = jnp.asarray(w)
        tb["client_weights"] = torch.from_numpy(w)
    return jb, tb


# --------------------------------------------------------------- data

@pytest.mark.parametrize("arch,clients,shards,seq,seed", [
    ("smollm-135m", 6, 4, 32, 0), ("zamba2-7b", 3, 2, 17, 5), ("qwen3-0.6b", 8, 4, 256, 1)])
def test_make_dataset_is_bit_equal(arch, clients, shards, seq, seed):
    want = jtrain.make_dataset(None, jax_smoke_config(arch), clients, shards, seq, seed=seed)
    got = ttrain.make_dataset(None, smoke_config(arch), clients, shards, seq, seed=seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ids,batch", [([0, 3], 4), ([1, 2, 5], 4), ([4], 3)])
def test_assemble_batch_is_bit_equal(ids, batch):
    jt = jtrain.build_task("smollm-135m", "tiny", 16, batch)
    tt = ttrain.build_task("smollm-135m", "tiny", 16, batch, device="cpu")
    data = jtrain.make_dataset(None, jt["cfg"], 6, 4, 16, seed=2)
    w = np.random.default_rng(0).random(len(ids)).astype(np.float32)
    rj, rt = np.random.default_rng(7), np.random.default_rng(7)
    jb = jtrain.assemble_batch(jt, data, np.asarray(ids), w, rj)
    tb = ttrain.assemble_batch(tt, data, np.asarray(ids), w, rt)
    assert set(tb) == set(jb) == {"tokens", "labels", "client_weights"}
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
    assert tb["client_weights"].dtype == torch.float32
    assert rt.bit_generator.state == rj.bit_generator.state


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-7b"])
def test_build_task_init_matches_jax(arch):
    jt = jtrain.build_task(arch, "tiny", 32, 4, tau=2)
    tt = ttrain.build_task(arch, "tiny", 32, 4, tau=2, device="cpu")
    assert tt["cfg"].ssm_chunk == jt["cfg"].ssm_chunk
    _assert_trees_close(tt["params"], jt["params"], atol=1e-6)
    _assert_trees_close(tt["opt"]["mu"], jt["opt"]["mu"], atol=0)
    assert int(tt["opt"]["count"]) == 0 and tt["step"] is None and tt["opt_local_fn"] is None


# --------------------------------------------------------------- gradients

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax(arch):
    jcfg, jparams, cfg, params = _carry(arch)
    jb, tb = _batch(cfg, 2, 24)
    gj = jax.jit(jax.grad(lambda p: jax_get_api(jcfg).loss_fn(p, jcfg, jb)[0]))(jparams)
    lt, gt = ttrain.loss_and_grads(get_api(cfg), cfg, params, tb)
    lj = jax_get_api(jcfg).loss_fn(jparams, jcfg, jb)[0]
    np.testing.assert_allclose(float(lt), float(lj), atol=1e-5, rtol=0)
    g, w = _flat(params_to_numpy(gt)), _flat(jax.tree.map(np.asarray, gj))
    assert set(g) == set(w)
    for k in w:
        tol = 1e-5 * max(1.0, float(np.abs(w[k]).max()))
        np.testing.assert_allclose(g[k], w[k], atol=tol, rtol=0, err_msg=k)


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-7b"])
def test_remat_and_chunk_checkpoints_change_no_gradient(arch):
    """``cfg.remat`` and ``ssm_checkpoint_chunks`` change memory only."""
    _, _, cfg, params = _carry(arch)
    _, tb = _batch(cfg, 2, 24)
    grads = {}
    for remat in (False, True):
        for chunks in (False, True):
            c = cfg.replace(remat=remat, ssm_checkpoint_chunks=chunks)
            grads[remat, chunks] = _flat(params_to_numpy(
                ttrain.loss_and_grads(get_api(c), c, params, tb)[1]))
    base = grads[False, False]
    for key, g in grads.items():
        for k in base:
            np.testing.assert_array_equal(g[k], base[k], err_msg=f"{key} {k}")


def test_rmsnorm_function_gradcheck_f64():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 16, dtype=torch.float64, generator=gen, requires_grad=True)
    w = torch.randn(16, dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b: rmsnorm_trainable(a, b, 1e-6), (x, w))


def test_rmsnorm_function_matches_autograd_through_the_plain_norm():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 7, 64, generator=gen)
    w = 1.0 + 0.1 * torch.randn(64, generator=gen)
    g = torch.randn(4, 7, 64, generator=gen)
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    xb, wb = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    ya, yb = rmsnorm_trainable(xa, wa, 1e-6), ref_rmsnorm(xb, wb, 1e-6)
    torch.testing.assert_close(ya, yb, atol=0, rtol=0)
    ya.backward(g)
    yb.backward(g)
    torch.testing.assert_close(xa.grad, xb.grad, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(wa.grad, wb.grad, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------- update rules

def test_arch_local_fn_tau2_matches_jax():
    jcfg, jparams, cfg, params = _carry("qwen3-0.6b")
    jb, tb = _batch(cfg, 3, 16, weights=False)
    row_fn = jtrain.arch_local_fn(jax_get_api(jcfg), jcfg, 2, 5e-3)
    want = [row_fn(jparams, None, {k: v[i:i + 1] for k, v in jb.items()}) for i in range(3)]
    rows = {k: v[:, None] for k, v in tb.items()}
    got, losses = ttrain.arch_local_fn(get_api(cfg), cfg, 2, 5e-3)(params, None, rows)
    assert losses.shape == (3,)
    for i, (pj, lj) in enumerate(want):
        _assert_trees_close(tree_map(lambda t: t[i], got), pj, atol=1e-5)
        np.testing.assert_allclose(float(losses[i]), float(lj), atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-7b"])
def test_arch_fused_step_two_steps_match_jax(arch):
    """Two AdamW server steps, each from the reference's params and state
    (carried across), so that one step's rounding does not feed the next
    step's gradients. AdamW divides each gradient element by its own
    ``sqrt(nu) + eps`` (eps 1e-8): where the reference's gradient is below
    ``ILL_CONDITIONED`` (100 eps) a rounding-sized gradient difference
    (about 1e-9 here) moves that element's step by up to a few percent, so
    1e-5 holds for the params only at the other elements. Those few are
    counted (``ADAM_SHARE``) and their worst difference is reported."""
    jcfg, jparams, cfg, _ = _carry(arch)
    japi_, api = jax_get_api(jcfg), get_api(cfg)
    jstep, _ = jtrain.arch_fused_step(japi_, jcfg)
    _, tlocal = ttrain.arch_fused_step(api, cfg)
    jgrad = jax.jit(jax.grad(lambda p, b: japi_.loss_fn(p, jcfg, b)[0]))
    jopt = jtrain.server_opt().init(jparams)
    for step, seed in enumerate((0, 1), start=1):
        params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        topt = adamw_state_from_numpy(jax.tree.map(np.asarray, jopt), device="cpu")
        jb, tb = _batch(cfg, 4, 16, seed=seed)
        grads = _flat(jax.tree.map(np.asarray, jgrad(jparams, jb)))
        lj, jparams, jopt = jstep(jparams, jopt, jb)
        (tp, to), lt = tlocal((params, topt), None, tree_map(lambda t: t[None], tb))
        np.testing.assert_allclose(float(lt[0]), float(lj), atol=1e-5, rtol=0)
        assert int(to["count"][0]) == int(jopt["count"]) == step
        g, w = _flat(params_to_numpy(tree_map(lambda t: t[0], tp))), _flat(
            jax.tree.map(np.asarray, jparams))
        ill = {k: np.abs(grads[k]) < ILL_CONDITIONED for k in w}
        for k in w:
            d = np.abs(g[k] - w[k])
            assert (d[~ill[k]] <= 1e-5).all(), (k, float(d[~ill[k]].max()))
        n_ill = sum(int((np.abs(g[k] - w[k]) > 1e-5).sum()) for k in w)
        worst = max(float(np.abs(g[k] - w[k]).max()) for k in w)
        print(f"{arch} step {step}: {n_ill} of {sum(v.size for v in w.values())} elements "
              f"beyond 1e-5, all where |g| < {ILL_CONDITIONED}; max |diff| {worst:.3g}")
        assert n_ill <= ADAM_SHARE * sum(v.size for v in w.values()), n_ill


ILL_CONDITIONED = 1e-6      # 100 x AdamW's eps
ADAM_SHARE = 1e-3           # at most this share of elements beyond 1e-5


# ------------------------------------------------------------- whole runs

def _spec(api, *, tau=1, backend=None, aggregator=None, mode="sync", arrivals=9, buffer=3):
    spec = api.ScenarioSpec.load(SPEC)
    for t in spec.tasks:
        t.options["tau"] = tau
    rt = spec.runtime
    rt.tau = tau
    rt.backend = backend or rt.backend
    rt.aggregator = aggregator
    if aggregator == "fedadam":
        rt.aggregator_options = {"lr": 0.1}
    rt.mode = mode
    rt.total_arrivals, rt.buffer_size = arrivals, buffer
    return spec


def _assert_runs_match(rt, rj, max_share=0.0):
    if rt.mode == "sync":
        np.testing.assert_array_equal(rt.alloc, rj.alloc)
        np.testing.assert_array_equal(rt.alloc_counts, rj.alloc_counts)
        np.testing.assert_array_equal(rt.wall_clock_sim, rj.wall_clock_sim)
    else:
        for key in EVENTS:
            np.testing.assert_array_equal(getattr(rt, key), getattr(rj, key), err_msg=key)
        assert rt.assignments == rj.assignments
    np.testing.assert_allclose(rt.loss, rj.loss, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(rt.acc, rj.acc)
    assert rt.task_names == rj.task_names
    for pt, pj in zip(rt.params, rj.params):
        _assert_trees_close(pt, pj, atol=1e-4, max_share=max_share)
    js, jj = rt.to_json(), rj.to_json()
    assert set(js) == set(jj) and js["spec"] == jj["spec"] and js["fairness"] == jj["fairness"]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(tau=2, backend="vmap", aggregator="fedadam"),
    dict(mode="async", aggregator=None),
    dict(mode="async", aggregator="fedadam"),
], ids=["tiny_two_task", "tau2_vmap_fedadam", "async_fedavg", "async_fedadam"])
def test_whole_run_matches_reference(kw):
    rt = tapi.run_scenario(_spec(tapi, **kw), device="cpu")
    rj = japi.run_scenario(_spec(japi, **kw))
    assert rt.mode == rj.mode == kw.get("mode", "sync")
    assert rt.acc is not None and rt.acc.shape == rt.loss.shape
    # sync tau 1 steps AdamW (eps 1e-8) on the server; everything else is
    # SGD with the FedOpt rules' eps 1e-3
    fused_adamw = kw.get("mode", "sync") == "sync" and kw.get("tau", 1) <= 1
    _assert_runs_match(rt, rj, ADAM_SHARE if fused_adamw else 0.0)


def test_train_cli_runs_on_the_cpu(capsys):
    res = ttrain.main(["--spec", SPEC, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "final losses:" in out and "on 1 cpu device(s)" in out
    assert res.mode == "sync" and np.isfinite(res.loss).all()


def test_train_cli_needs_cuda_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--spec", SPEC])


@pytest.mark.parametrize("mode", [[], ["--async", "--arrivals", "2"]], ids=["sync", "async"])
@pytest.mark.parametrize("flags,item", [
    (["--population", "vectorized"], None),
    (["--checkpoint-dir", "ckpt"], None),
    (["--backend", "sharded"], "vmap"),
], ids=["population", "checkpoint", "sharded"])
def test_train_cli_refusals_name_their_items(mode, flags, item, tmp_path):
    """Nothing is refused any more: --population, --checkpoint-dir (then
    --resume) and --backend sharded (once refused naming ROADMAP item 14)
    reach run_scenario and run; the sharded run equals ``--backend
    item``'s within 1e-6."""
    argv = ["--archs", "smollm-135m", "--clients", "2", "--rounds", "1", "--seq", "8",
            "--batch", "2", "--device", "cpu"] + mode
    # one intra-op thread: the suite's worker processes share the CPU
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        if flags[0] == "--checkpoint-dir":
            flags = ["--checkpoint-dir", str(tmp_path / "ckpt"), "--ckpt-every", "1"]
            first = ttrain.main(argv + flags)
            res = ttrain.main(argv + flags + ["--resume"])
            np.testing.assert_array_equal(res.loss, first.loss)
        else:
            res = ttrain.main(argv + flags)
        if item is not None:
            want = ttrain.main(argv + ["--backend", item])
            np.testing.assert_array_equal(res.alloc, want.alloc)
            np.testing.assert_allclose(res.loss, want.loss, atol=1e-6, rtol=0)
    finally:
        torch.set_num_threads(threads)
    assert res.mode == ("async" if mode else "sync") and int(res.arrivals.sum()) >= 1


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels cannot run on the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_rmsnorm_function_on_cuda_matches_cpu(cuda_device):
    gen = torch.Generator().manual_seed(2)
    x, w, g = torch.randn(256, 576, generator=gen), torch.randn(576, generator=gen), \
        torch.randn(256, 576, generator=gen)
    out = {}
    for dev in ("cpu", cuda_device):
        xd = x.to(dev).clone().requires_grad_(True)
        wd = w.to(dev).clone().requires_grad_(True)
        reset_launches()
        y = rmsnorm_trainable(xd, wd, 1e-6)
        y.backward(g.to(dev))
        out[str(dev)] = (y.detach().cpu(), xd.grad.cpu(), wd.grad.cpu(), dict(LAUNCHES))
    (yc, dxc, dwc, _), (yg, dxg, dwg, launches) = out["cpu"], out[str(cuda_device)]
    assert launches.get("rmsnorm") == 1
    torch.testing.assert_close(yg, yc, atol=1e-5, rtol=0)
    torch.testing.assert_close(dxg, dxc, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dwg, dwc, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_arch_local_fn_on_cuda_matches_cpu(cuda_device):
    cfg = smoke_config("smollm-135m")
    params = get_api(cfg).init_params(prng.PRNGKey(4), cfg, device="cpu")
    _, tb = _batch(cfg, 3, 32, weights=False)
    rows = {k: v[:, None] for k, v in tb.items()}
    fn = ttrain.arch_local_fn(get_api(cfg), cfg, 2, 5e-3)
    cpu, lc = fn(params, None, rows)
    reset_launches()
    gpu, lg = fn(tree_map(lambda t: t.to(cuda_device), params), None,
                 tree_map(lambda t: t.to(cuda_device), rows))
    torch.cuda.synchronize()
    # every norm of each forward: 2 per layer and the final one, 2 steps, 3 rows
    assert LAUNCHES["rmsnorm"] == 3 * 2 * (2 * cfg.n_layers + 1)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=0)
    for a, b in zip(_flat(params_to_numpy(gpu)).values(), _flat(params_to_numpy(cpu)).values()):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
