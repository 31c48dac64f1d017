"""The port's partition rules and meshes (``repro_torch.sharding``,
``repro_torch.launch.mesh``) against the JAX package's, and a real SPMD
AdamW step on DTensors.

The specs of every assigned arch at full size equal the JAX package's
leaf by leaf (parameters, decode caches, batches), on a 16 x 16 mesh of
axis sizes as ``tests/test_sharding.py`` holds them. The SPMD step runs a
qwen3 smoke model on a (2, 2) ('data', 'model') mesh of 4 gloo ranks on
the CPU: its loss, gradients and AdamW step against the port's plain
tensors and the JAX package's loss. The card's cases are in
``tests/test_torch_dtensor_cuda.py``, which imports no JAX.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import get_api as jax_get_api
from repro.sharding import partition as jpart
from repro_torch import prng
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.models import get_api
from repro_torch.sharding import partition as part

ROOT = Path(__file__).resolve().parents[1]
SIZES = {"data": 16, "model": 16}


class FakeMesh:
    """The JAX side's mesh stand-in (``tests/test_sharding.py``)."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)
        self.devices = np.empty(tuple(sizes.values()))


class FakeDeviceMesh:
    """The port's: what the spec functions read of a ``DeviceMesh``."""

    def __init__(self, sizes):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())
        self.ndim = len(sizes)


@pytest.fixture
def sizes():
    """Both packages' contexts at the 16 x 16 production axis sizes."""
    jpart.clear_sharding_ctx()
    part.clear_sharding_ctx()
    jpart._CTX["axis_sizes"] = dict(SIZES)
    part._CTX["axis_sizes"] = dict(SIZES)
    yield
    jpart.clear_sharding_ctx()
    part.clear_sharding_ctx()


def _jax_leaves(tree, is_leaf=None):
    """{path of key names: leaf} of a JAX tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p): v for p, v in flat}


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, path + (k,)))
        return out
    return {path: tree}


def _jax_specs(arch):
    cfg = jax_get_config(arch).replace(param_dtype="bfloat16")
    api = jax_get_api(cfg)
    shapes = jax.eval_shape(lambda k: api.init_params(k, cfg), jax.random.key(0))
    specs = jax.tree_util.tree_map_with_path(lambda p, x: jpart.param_spec(p, x, cfg), shapes)
    return cfg, shapes, specs


def _port_params(arch):
    cfg = get_config(arch).replace(param_dtype="bfloat16")
    params = get_api(cfg).init_params(prng.PRNGKey(0, device="meta"), cfg, device="meta")
    return cfg, params


# ------------------------------------------------------------ spec rules

def test_assigned_archs_equal_the_reference():
    assert ASSIGNED_ARCHS == JAX_ASSIGNED_ARCHS


def test_on_local_shards_of_plain_tensors_is_the_call():
    """With no DTensor among the inputs ``on_local_shards`` calls the
    function on them as they are, so model code calls it on every path."""
    x, y = torch.ones(2, 3), torch.zeros(3)
    got = part.on_local_shards(lambda a, b, *, k: (a, b, k), (x, y), ((-1,), (0,)), k=7)
    assert got[0] is x and got[1] is y and got[2] == 7


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_equal_the_reference(arch, sizes):
    """The port's specs of its meta-device params equal the JAX package's
    of ``eval_shape(init_params)`` leaf by leaf at full size, and every
    sharded axis divides its dim (the invariant the 16 x 16 dry-run
    relies on)."""
    _, jshapes, jspecs = _jax_specs(arch)
    cfg, params = _port_params(arch)
    specs = part.tree_param_specs(params, cfg)
    want = {p: tuple(s) for p, s in _jax_leaves(
        jspecs, is_leaf=lambda x: isinstance(x, jpart.P)).items()}
    got = _port_leaves(specs)
    leaves = _port_leaves(params)
    assert set(got) == set(want) == set(_jax_leaves(jshapes))
    for path, spec in got.items():
        assert spec == want[path], (path, spec, want[path])
        shape = tuple(leaves[path].shape)
        assert len(spec) == len(shape), (path, spec, shape)
        for dim, names in zip(shape, spec):
            if names is not None:
                ns = (names,) if isinstance(names, str) else names
                assert dim % 16 ** len(ns) == 0, (path, shape, spec)


def test_big_weights_are_sharded(sizes):
    """The 110b config's embedding and FFN weights are 2-D sharded
    (``tests/test_sharding.py::test_big_weights_are_sharded``)."""
    cfg, params = _port_params("qwen1.5-110b")
    specs = part.tree_param_specs(params, cfg)
    assert specs["emb"]["tok"] == ("model", "data")
    blk = specs["dense_layers"]
    assert blk["ffn"]["gate"] == (None, "data", "model")
    assert blk["ffn"]["down"] == (None, "model", "data")


def test_expert_parallel_when_divisible(sizes):
    """deepseek's 64 experts shard on 'model'; qwen2-moe's 60 fall back to
    the ff axis, on both packages."""
    path = ("moe_layers", "ffn", "gate")
    jpath = tuple(jax.tree_util.DictKey(k) for k in path)
    for arch, shape in (("deepseek-v2-lite-16b", (26, 64, 2048, 1408)),
                        ("qwen2-moe-a2.7b", (24, 60, 2048, 1408))):
        leaf = torch.empty(shape, device="meta")
        got = part.param_spec(path, leaf, get_config(arch))
        want = jpart.param_spec(jpath, jax.ShapeDtypeStruct(shape, "bfloat16"),
                                jax_get_config(arch))
        assert got == tuple(want)
    assert part.param_spec(path, torch.empty(26, 64, 2048, 1408, device="meta"),
                           get_config("deepseek-v2-lite-16b"))[1] == "model"
    spec2 = part.param_spec(path, torch.empty(24, 60, 2048, 1408, device="meta"),
                            get_config("qwen2-moe-a2.7b"))
    assert spec2[1] is None and spec2[3] == "model"


def test_constrain_noop_without_ctx_or_dtensor():
    """No context entry, a plain tensor, or a rank other than the spec's:
    ``constrain`` returns its input itself."""
    part.clear_sharding_ctx()
    x = torch.ones(4, 4)
    assert part.constrain(x, "activation") is x
    part.set_sharding_ctx(activation=(FakeDeviceMesh(SIZES), part.P("data", None, "model")))
    try:
        assert part.constrain(x, "activation") is x
    finally:
        part.clear_sharding_ctx()


@pytest.mark.parametrize("arch,mode", [(a, "latent") for a in ASSIGNED_ARCHS]
                         + [("deepseek-v2-lite-16b", "seq")])
def test_cache_specs_equal_the_reference(arch, mode):
    """Every leaf of each arch's decode cache (B 16, 1024 slots) gets the
    JAX package's spec on a 16 x 16 mesh; deepseek's MLA latent caches in
    both ``mla_cache_shard`` modes (the default 'latent', and 'seq')."""
    jcfg = jax_get_config(arch).replace(param_dtype="bfloat16")
    japi = jax_get_api(jcfg)
    jshapes = jax.eval_shape(lambda k: japi.init_params(k, jcfg), jax.random.key(0))
    jcache = jax.eval_shape(lambda: japi.init_cache_fn(jshapes, jcfg, 16, 1024, jax.numpy.bfloat16))
    cfg, params = _port_params(arch)
    cache = get_api(cfg).init_cache_fn(params, cfg, 16, 1024, torch.bfloat16)
    jmesh, mesh = FakeMesh(SIZES), FakeDeviceMesh(SIZES)
    jpart.clear_sharding_ctx()
    part.clear_sharding_ctx()
    jpart.set_sharding_ctx(mla_cache_shard=mode)
    part.set_sharding_ctx(mla_cache_shard=mode)
    try:
        want = {p: tuple(jpart.cache_spec(tuple(jax.tree_util.DictKey(k) for k in p), s, jmesh, 16))
                for p, s in _jax_leaves(jcache).items()}
        got = {p: part.cache_spec(p, t, mesh, 16) for p, t in _port_leaves(cache).items()
               if t is not None}
    finally:
        jpart.clear_sharding_ctx()
        part.clear_sharding_ctx()
    assert got == want


@pytest.mark.parametrize("sizes_", [{"data": 16, "model": 16},
                                    {"pod": 2, "data": 16, "model": 16}], ids=["pod1", "pod2"])
def test_batch_spec_and_dp_axes_equal_the_reference(sizes_):
    jmesh, mesh = FakeMesh(sizes_), FakeDeviceMesh(sizes_)
    assert part.dp_axes(mesh) == jpart.dp_axes(jmesh)
    for B in (1, 8, 16, 32, 48, 64, 256, 512):
        for ndim in (1, 2, 3):
            assert part.batch_spec(mesh, B, ndim) == tuple(jpart.batch_spec(jmesh, B, ndim)), \
                (sizes_, B, ndim)


def test_placements_of_a_three_axis_mesh():
    """('pod', 'data') on one dim shards it in mesh-axis order; a spec
    naming them out of that order, an axis twice, or an axis the mesh
    lacks raises."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeDeviceMesh({"pod": 2, "data": 16, "model": 16})
    assert part.placements(mesh, part.P(("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert part.placements(mesh, part.P(None, "data")) == [Replicate(), Shard(1), Replicate()]
    assert part.placements(mesh, part.P(None, None)) == [Replicate()] * 3
    with pytest.raises(ValueError, match="out of the mesh's axis order"):
        part.placements(mesh, part.P(("data", "pod"), None))
    with pytest.raises(ValueError, match="twice"):
        part.placements(mesh, part.P("data", "data"))
    with pytest.raises(ValueError, match="not axes of the mesh"):
        part.placements(mesh, part.P("expert", None))


def test_cohort_mesh_on_the_cpu_and_the_device_rule(monkeypatch):
    from repro_torch.launch.mesh import make_cohort_mesh

    assert make_cohort_mesh(device="cpu") == (torch.device("cpu"),)
    assert make_cohort_mesh(3, device="cpu") == (torch.device("cpu"),)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_cohort_mesh()


def test_meshes_need_a_process_group():
    """Without an initialised process group both group meshes raise,
    naming the ranks they need."""
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

    with pytest.raises(RuntimeError, match=r"\(16, 16\) needs 256 ranks, have 0"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match=r"\(2, 16, 16\) needs 512 ranks, have 0"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match=r"needs 4 ranks"):
        make_test_mesh((2, 2), device_type="cpu")


# ------------------------------------------------------------ SPMD step

SPMD_PROG = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    B, S, S_FLASH = 8, 16, 128


    def cfg_of():
        from repro_torch.configs import smoke_config
        return smoke_config("qwen3-0.6b").replace(
            d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=256)


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
            else:
                out[prefix + k] = v
        return out


    def batch_of(seed, seq):
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, 256, (B, seq + 1))
        return {"tokens": torch.from_numpy(toks[:, :-1]).long(),
                "labels": torch.from_numpy(toks[:, 1:]).long()}


    def main(rank, world, store_path, inp, outp):
        torch.set_num_threads(1)
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
        try:
            run(rank, inp, outp)
        finally:
            dist.destroy_process_group()


    def run(rank, inp, outp):
        from torch.distributed.tensor import DTensor, distribute_tensor

        from repro_torch import prng
        from repro_torch.configs import smoke_config
        from repro_torch.interop import lm_params_from_numpy, params_to_numpy
        from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
        from repro_torch.models import get_api
        from repro_torch.optim import adamw
        from repro_torch.sharding import partition as part

        cfg = cfg_of()
        api = get_api(cfg)
        jparams = nested(dict(np.load(inp)))
        opt = adamw(lr=1e-3)
        res = {}
        mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
        try:
            make_production_mesh()
        except RuntimeError as e:
            res["production_mesh"] = str(e)

        def step(params, batch, c):
            leaves = {k: v.requires_grad_() for k, v in flat(params).items()}
            loss, _ = api.loss_fn(nested(leaves), c, batch)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            with torch.no_grad():
                new, _ = opt.update(nested({k: v.detach() for k, v in leaves.items()}),
                                    nested(grads), opt.init(params))
            return loss.detach(), grads, new

        batch = batch_of(0, S)
        plain = lm_params_from_numpy(jparams, cfg, device="cpu")
        loss, grads, new = step(plain, batch, cfg)
        res["plain_loss"] = float(loss)
        arrays = {f"plain_grad/{k}": g.numpy() for k, g in grads.items()}
        arrays.update({f"plain_new/{k}": v.numpy() for k, v in flat(new).items()})
        fb = batch_of(1, S_FLASH)
        pcfg = cfg.replace(use_pallas=True)
        with torch.no_grad():
            res["plain_flash_loss"] = float(api.loss_fn(plain, pcfg, fb)[0])

        for act in ("seq", "dmodel"):
            with part.use_mesh(mesh):
                dp = part.dp_axes(mesh)
                part.set_sharding_ctx(
                    activation=(mesh, {"seq": part.P(dp, "model", None),
                                       "dmodel": part.P(dp, None, "model")}[act]),
                    logits=(mesh, part.P(dp, None, "model")))
                specs = part.tree_param_specs(plain, cfg)
                params = part.distribute_tree(
                    lm_params_from_numpy(jparams, cfg, device="cpu"), specs, mesh)
                want = {k: list(v.placements) for k, v in flat(params).items()}
                sharded = sorted(k for k, v in want.items()
                                 if any(p.is_shard() for p in v))
                b = {k: distribute_tensor(v, mesh, part.placements(
                    mesh, part.batch_spec(mesh, B, v.ndim))) for k, v in batch.items()}
                loss, grads, new = step(params, b, cfg)
                kept = all(isinstance(v, DTensor) and list(v.placements) == want[k]
                           for k, v in flat(new).items())
                grads_full = params_to_numpy(grads)
                new_full = params_to_numpy(flat(new))
                fbd = {k: distribute_tensor(v, mesh, part.placements(
                    mesh, part.batch_spec(mesh, B, v.ndim))) for k, v in fb.items()}
                with torch.no_grad():
                    flash_loss = api.loss_fn(params, pcfg, fbd)[0].full_tensor()
                res[act] = {"loss": float(loss.full_tensor()), "placements_kept": kept,
                            "sharded_leaves": sharded, "flash_loss": float(flash_loss),
                            "loss_is_dtensor": isinstance(loss, DTensor)}
                arrays.update({f"{act}_grad/{k}": v for k, v in grads_full.items()})
                arrays.update({f"{act}_new/{k}": v for k, v in new_full.items()})

        mcfg = smoke_config("qwen2-moe-a2.7b")
        mapi = get_api(mcfg)
        mp_ = mapi.init_params(prng.PRNGKey(0, device="cpu"), mcfg, device="cpu")
        res["moe_plain_loss"] = float(mapi.loss_fn(mp_, mcfg, batch)[0])
        with part.use_mesh(mesh):
            mp_ = part.distribute_tree(mp_, part.tree_param_specs(mp_, mcfg), mesh)
            mb = {k: distribute_tensor(v, mesh, part.placements(
                mesh, part.batch_spec(mesh, B, v.ndim))) for k, v in batch.items()}
            res["moe_loss"] = float(mapi.loss_fn(mp_, mcfg, mb)[0].full_tensor())
        if rank == 0:
            np.savez(outp + ".npz", **arrays)
            with open(outp + ".json", "w") as f:
                json.dump(res, f)


    if __name__ == "__main__":
        store_path, inp, outp = sys.argv[1:4]
        mp.spawn(main, args=(4, store_path, inp, outp), nprocs=4, join=True)
""")


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_sharded_train_step_4_gloo_ranks(tmp_path):
    """A real SPMD AdamW step of the reference test's qwen3 smoke model on a
    (2, 2) ('data', 'model') mesh of 4 gloo ranks (the reference runs 4 x
    2 over 8 host devices), with the activations constrained by sequence
    and, in a second pass, by d_model, and the logits by vocab. The loss
    equals the port's plain loss within 1e-6 and the JAX package's
    within 1e-5, the gradients the plain ones within 1e-6 x max(1,
    max|g|), the params after one step the plain step's by the first-step
    AdamW rule of ``tests/test_torch_train.py``, and every leaf keeps its
    placements. The use_pallas loss at S 128 takes flash on the local
    shards; a MoE config's loss under the mesh equals its plain loss
    within 1e-6; the production mesh on 4 ranks raises naming both
    counts."""
    jcfg = jax_smoke_config("qwen3-0.6b").replace(
        d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=256)
    japi = jax_get_api(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    np.savez(tmp_path / "params.npz", **_flat_np(jparams))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (8, 17))
    jloss = float(japi.loss_fn(jparams, jcfg, {"tokens": jax.numpy.asarray(toks[:, :-1]),
                                               "labels": jax.numpy.asarray(toks[:, 1:])})[0])

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = str(tmp_path / "out")
    prog = tmp_path / "spmd_step.py"
    prog.write_text(SPMD_PROG)
    proc = subprocess.run([sys.executable, str(prog), str(tmp_path / "store"),
                           str(tmp_path / "params.npz"), out],
                          capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(Path(out + ".json").read_text())
    arrays = dict(np.load(out + ".npz"))
    assert "needs 256 ranks, have 4" in res["production_mesh"]
    np.testing.assert_allclose(res["moe_loss"], res["moe_plain_loss"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(res["plain_loss"], jloss, atol=1e-5, rtol=0)
    names = sorted(k.split("/", 1)[1] for k in arrays if k.startswith("plain_grad/"))
    for act in ("seq", "dmodel"):
        r = res[act]
        assert r["loss_is_dtensor"] and r["placements_kept"], act
        # the 2-D weights are split on both axes, the norms replicated
        assert "dense_layers/attn/wq" in r["sharded_leaves"] and "emb/tok" in r["sharded_leaves"]
        np.testing.assert_allclose(r["loss"], res["plain_loss"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(r["loss"], jloss, atol=1e-5, rtol=0)
        np.testing.assert_allclose(r["flash_loss"], res["plain_flash_loss"], atol=1e-6, rtol=0)
        n_ill = total = 0
        for k in names:
            g, gd = arrays[f"plain_grad/{k}"], arrays[f"{act}_grad/{k}"]
            tol = 1e-6 * max(1.0, float(np.abs(g).max()))
            assert np.abs(gd - g).max() <= tol, (act, k, float(np.abs(gd - g).max()))
            d = np.abs(arrays[f"{act}_new/{k}"] - arrays[f"plain_new/{k}"])
            ill = np.abs(g) < 1e-6
            assert (d[~ill] <= 1e-5).all(), (act, k, float(d[~ill].max()))
            n_ill += int((d > 1e-5).sum())
            total += d.size
        assert n_ill <= 1e-3 * total, (act, n_ill)
