"""Every model family on DTensors: the MoE, MLA, hybrid, xLSTM and
encoder-decoder LMs, and the head split at a head count the model axis
does not divide, on a (2, 2) ('data', 'model') mesh of 4 gloo ranks.

Each case takes the JAX package's smoke model (params carried across by
``interop``) and holds the port on DTensors against the port on plain
tensors: the loss within 1e-6, the gradients within 1e-6 x max(1,
max|g|), the params after one AdamW step by the first-step rule of
``tests/test_torch_train.py``, every leaf keeping its placements, the
``use_pallas`` loss with every kernel wrapper reached on plain local
shards (the same calls per forward as plain tensors), and a prefill and 4
greedy tokens with caches laid out by ``partition.cache_spec``: identical
tokens, logits within 1e-5, identical MoE routing. The DTensor loss
equals the JAX package's within 1e-5.

This file is also the SPMD program: run as a script it spawns 4 gloo
ranks over a ``FileStore`` (a default process group is never set in a
test worker) and writes each case's results for the tests to read.
``tests/test_torch_dtensor_families2.py`` runs the other half of the
cases through it.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
B, S, S_FLASH, GEN = 8, 16, 128, 4

# name -> (arch, smoke overrides, activation constraint, decode settings)
CASES = {
    # 6 heads / 3 kv heads on the 2-way model axis: the projections split,
    # the heads not
    "heads_6_3": ("qwen3-0.6b", dict(d_model=128, n_heads=6, n_kv_heads=3, head_dim=32,
                                     d_ff=128, vocab_size=256), "seq", ({},)),
    # one head a rank: the attention's gradients are laid out transposed
    "one_head_a_rank": ("qwen1.5-0.5b", dict(d_model=128, n_heads=2, n_kv_heads=2,
                                             head_dim=64, d_ff=128, vocab_size=256),
                        "dmodel", ({},)),
    # the dispatch groups follow the batch split (2 groups on the 2-way data axis)
    "moe": ("qwen2-moe-a2.7b", dict(moe_groups=2), "seq", ({},)),
    "mla": ("deepseek-v2-lite-16b", {}, "dmodel",
            ({"mla_absorb": False, "mla_cache_shard": "latent"},
             {"mla_absorb": True, "mla_cache_shard": "seq"})),
    "hybrid": ("zamba2-7b", {}, "seq", ({},)),
    "xlstm": ("xlstm-1.3b", {}, "dmodel", ({},)),
    "encdec": ("whisper-medium", {}, "seq", ({},)),
}
FIRST = ("heads_6_3", "one_head_a_rank", "moe", "mla")
COUNTED = (("models.layers", "_rms_norm"), ("models.attention", "flash_attention"),
           ("models.ssm", "ssd_scan"), ("models.ssm", "gated_rmsnorm"))


def smoke(arch, over, jax_side=False):
    if jax_side:
        from repro.configs import smoke_config
    else:
        from repro_torch.configs import smoke_config
    return smoke_config(arch).replace(**over)


def batch_np(cfg, seed, seq):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, seq + 1))
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.arch_type == "audio":
        out["frames"] = rng.standard_normal((B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return out


# ------------------------------------------------------------ the program

def nested(flat):
    out = {}
    for key, value in flat.items():
        node = out
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = value
    return out


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[prefix + k] = v
    return out


def main(rank, world, store_path, workdir, cases):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        for name in cases:
            res, arrays = run_case(name, workdir)
            if rank == 0:
                np.savez(os.path.join(workdir, f"{name}.npz"), **arrays)
                Path(workdir, f"{name}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def run_case(name, workdir):
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.interop import lm_params_from_numpy, params_to_numpy
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import get_api, pad_cache
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import adamw
    from repro_torch.sharding import partition as part
    from repro_torch.tree import tree_map

    arch, over, act, decodes = CASES[name]
    cfg = smoke(arch, over)
    api = get_api(cfg)
    jparams = nested(dict(np.load(os.path.join(workdir, f"{name}_params.npz"))))
    opt = adamw(lr=1e-3)
    mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
    res, arrays = {}, {}

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    # count the kernel wrappers' calls, and that none sees a DTensor
    calls = {"n": {}, "dtensor": 0}
    for mod, fn in COUNTED:
        module = sys.modules[f"repro_torch.{mod}"]
        orig = getattr(module, fn)

        def counted(*a, _orig=orig, _fn=fn, **kw):
            calls["n"][_fn] = calls["n"].get(_fn, 0) + 1
            calls["dtensor"] += sum(isinstance(t, DTensor) for t in a)
            return _orig(*a, **kw)

        setattr(module, fn, counted)
    routes = []
    orig_route = moe_mod.moe_route

    def route(p, c, xf):
        out = orig_route(p, c, xf)
        routes.append([t.detach().clone() for t in (out[1], out[3])])   # topi, idx
        return out

    moe_mod.moe_route = route

    def to_batch(npb, dist_=False):
        b = {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
             for k, v in npb.items()}
        if dist_:
            b = {k: distribute_tensor(v, mesh, part.placements(
                mesh, part.batch_spec(mesh, B, v.ndim))) for k, v in b.items()}
        return b

    def step(params, batch, c=cfg):
        leaves = {k: v.requires_grad_() for k, v in flat(params).items()}
        loss, _ = api.loss_fn(nested(leaves), c, batch)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        with torch.no_grad():
            new, _ = opt.update(nested({k: v.detach() for k, v in leaves.items()}),
                                nested(grads), opt.init(params))
        return loss.detach(), grads, new

    def pallas_loss(params, batch):
        calls["n"].clear()
        calls["dtensor"] = 0
        with torch.no_grad():
            loss = full(api.loss_fn(params, cfg.replace(use_pallas=True), batch)[0])
        return float(loss), dict(calls["n"]), calls["dtensor"]

    @torch.no_grad()
    def generate(params, c, batch, sharded):
        routes.clear()
        logits, caches = api.prefill_fn(params, c, batch)
        caches = pad_cache(caches, S, S + GEN)
        if sharded:
            caches = part.distribute_caches(caches, mesh, B)
        toks, logs = [], [full(logits)[:, -1]]
        tok = torch.argmax(logits[:, -1:, :c.vocab_size], dim=-1)
        for i in range(GEN):
            toks.append(full(tok))
            logits, caches = api.decode_fn(params, c, tok, S + i, caches)
            logs.append(full(logits)[:, -1])
            tok = torch.argmax(logits[:, -1:, :c.vocab_size], dim=-1)
        placed = all(list(t.placements) == part.placements(
            mesh, part.cache_spec(tuple(k.split("/")), t, mesh, B))
            for k, t in flat(caches).items()) if sharded else True
        return (torch.cat(toks, 1), torch.stack(logs), [[t.clone() for t in r] for r in routes],
                placed)

    batch_np_ = batch_np(cfg, 0, S)
    flash_np = batch_np(cfg, 1, S_FLASH)
    plain = lm_params_from_numpy(jparams, cfg, device="cpu")
    loss, grads, new = step(plain, to_batch(batch_np_))
    res["plain_loss"] = float(loss)
    arrays.update({f"plain_grad/{k}": g.numpy() for k, g in grads.items()})
    # the exact gradient's stand-in: the plain path in float64
    grads64 = step(tree_map(lambda t: t.double(), plain), {
        k: v.double() if v.is_floating_point() else v for k, v in to_batch(batch_np_).items()},
        cfg.replace(param_dtype="float64"))[1]
    arrays.update({f"f64_grad/{k}": g.numpy() for k, g in grads64.items()})
    arrays.update({f"plain_new/{k}": v.numpy() for k, v in flat(new).items()})
    res["plain_pallas"] = pallas_loss(plain, to_batch(flash_np))
    gens = [generate(plain, cfg.replace(**d), to_batch(batch_np_), False) for d in decodes]

    with part.use_mesh(mesh):
        dp = part.dp_axes(mesh)
        part.set_sharding_ctx(activation=(mesh, {"seq": part.P(dp, "model", None),
                                                 "dmodel": part.P(dp, None, "model")}[act]),
                              logits=(mesh, part.P(dp, None, "model")))
        params = part.distribute_tree(lm_params_from_numpy(jparams, cfg, device="cpu"),
                                      part.tree_param_specs(plain, cfg), mesh)
        want = {k: list(v.placements) for k, v in flat(params).items()}
        loss, grads, new = step(params, to_batch(batch_np_, True))
        res["placements_kept"] = all(isinstance(v, DTensor) and list(v.placements) == want[k]
                                     for k, v in flat(new).items())
        res["sharded_leaves"] = sorted(k for k, v in want.items()
                                       if any(p.is_shard() for p in v))
        res["loss"] = float(loss.full_tensor())
        arrays.update({f"grad/{k}": v for k, v in params_to_numpy(grads).items()})
        arrays.update({f"new/{k}": v for k, v in params_to_numpy(flat(new)).items()})
        res["pallas"] = pallas_loss(params, to_batch(flash_np, True))
        res["decode"] = []
        for d, (ptok, plog, proutes, _) in zip(decodes, gens):
            part.set_sharding_ctx(mla_cache_shard=d.get("mla_cache_shard", "latent"))
            dtok, dlog, droutes, placed = generate(params, cfg.replace(**d),
                                                   to_batch(batch_np_, True), True)
            res["decode"].append({
                "settings": d, "tokens_equal": bool(torch.equal(ptok, dtok)),
                "logits_max_diff": float((plog - dlog).abs().max()),
                # rank 0 routes the first groups of each call on its shards
                "routes_equal": len(proutes) == len(droutes) and all(
                    torch.equal(a[:len(b)], b) for pr, dr in zip(proutes, droutes)
                    for a, b in zip(pr, dr)),
                "n_routes": len(droutes), "caches_placed": placed,
                "tokens": ptok.tolist()})
    moe_mod.moe_route = orig_route
    return res, arrays


# ------------------------------------------------------------ the tests

def run_cases(tmp, cases):
    """The JAX side (params and loss of each case), then the 4-rank program
    over ``cases``; returns {case: (results, arrays, JAX loss)}."""
    import jax

    from repro.models import get_api as jax_get_api

    jloss = {}
    for name in cases:
        arch, over, _, _ = CASES[name]
        jcfg = smoke(arch, over, jax_side=True)
        japi = jax_get_api(jcfg)
        jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
        np.savez(tmp / f"{name}_params.npz", **{k: np.asarray(v) for k, v in
                                               flat(jax.tree.map(np.asarray, jparams)).items()})
        jb = {k: jax.numpy.asarray(v) for k, v in batch_np(jcfg, 0, S).items()}
        jloss[name] = float(japi.loss_fn(jparams, jcfg, jb)[0])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), str(tmp / "store"),
                           str(tmp), *cases], capture_output=True, text=True, timeout=600,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-6000:]
    return {name: (json.loads((tmp / f"{name}.json").read_text()),
                   dict(np.load(tmp / f"{name}.npz")), jloss[name]) for name in cases}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("dtensor_families"), FIRST)


def check_loss(r):
    res, _, jloss = r
    np.testing.assert_allclose(res["loss"], res["plain_loss"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(res["loss"], jloss, atol=1e-5, rtol=0)


def check_grads_and_step(r):
    res, arrays, _ = r
    assert res["placements_kept"] and res["sharded_leaves"]
    names = sorted(k.split("/", 1)[1] for k in arrays if k.startswith("plain_grad/"))
    n_ill = total = 0
    for k in names:
        g, gd = arrays[f"plain_grad/{k}"], arrays[f"grad/{k}"]
        # 1e-6 x max(1, max|g|), or twice the plain f32 gradient's own
        # distance from the float64 one where that is larger (xLSTM's mLSTM:
        # 4.75e-06 x max(1, max|g|) at the embedding)
        own = float(np.abs(g - arrays[f"f64_grad/{k}"]).max())
        tol = max(1e-6 * max(1.0, float(np.abs(g).max())), 2 * own)
        assert np.abs(gd - g).max() <= tol, (k, float(np.abs(gd - g).max()), own)
        d = np.abs(arrays[f"new/{k}"] - arrays[f"plain_new/{k}"])
        ill = np.abs(g) < 1e-6
        assert (d[~ill] <= 1e-5).all(), (k, float(d[~ill].max()))
        n_ill += int((d > 1e-5).sum())
        total += d.size
    assert n_ill <= 1e-3 * total, n_ill


def check_pallas(r):
    res, _, _ = r
    (lw, nw, dw), (lg, ng, dg) = res["plain_pallas"], res["pallas"]
    np.testing.assert_allclose(lg, lw, atol=1e-6, rtol=0)
    assert nw == ng and dw == dg == 0, (nw, ng, dg)
    return ng


def check_decode(r):
    res, _, _ = r
    for d in res["decode"]:
        assert d["tokens_equal"] and d["caches_placed"] and d["routes_equal"], d
        assert d["logits_max_diff"] <= 1e-5, d


@pytest.mark.parametrize("case", FIRST)
def test_loss_equals_plain_and_reference(results, case):
    """The DTensor loss equals the plain one within 1e-6 and the JAX
    package's within 1e-5."""
    check_loss(results[case])


@pytest.mark.parametrize("case", FIRST)
def test_grads_and_adamw_step(results, case):
    """Gradients within 1e-6 x max(1, max|g|) of plain, one AdamW step by
    the first-step rule, placements kept."""
    check_grads_and_step(results[case])


@pytest.mark.parametrize("case", FIRST)
def test_use_pallas_loss_on_local_shards(results, case):
    """The use_pallas loss (the kernels' plain versions on this CPU) equals
    plain; every wrapper call gets plain local shards, as many as plain."""
    n = check_pallas(results[case])
    assert n["_rms_norm"] and (case == "mla" or n["flash_attention"] == 2), n


@pytest.mark.parametrize("case", FIRST)
def test_prefill_and_decode_with_cache_spec_caches(results, case):
    """Prefill and 4 greedy tokens with ``cache_spec`` caches: identical
    tokens and MoE routing, logits within 1e-5 (MLA in both decode
    settings, its cache split by latent and by sequence)."""
    check_decode(results[case])
    if case in ("moe", "mla"):
        assert all(d["n_routes"] for d in results[case][0]["decode"])


if __name__ == "__main__":
    import torch.multiprocessing as mp

    store_path, workdir, *cases = sys.argv[1:]
    mp.spawn(main, args=(4, store_path, workdir, cases), nprocs=4, join=True)
