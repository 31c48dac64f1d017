"""Multi-pod dry-run: every (arch x input shape x mesh) combination built
sharded at production size and traced through its step, without
allocating a model byte.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k [--multi-pod] [--tuned] [--override k=v] [--out F]

The port's counterpart of the JAX package's ``launch/dryrun.py``, with its
flags, settings (``tuned_config``, ``TUNED_*``) and record. Where that one
sets ``XLA_FLAGS`` for 512 host devices, this one starts its own fake
process group of 256 or 512 ranks (``torch.distributed``'s ``"fake"``
backend) in its own process, so the production mesh (16x16, or 2x16x16
with ``--multi-pod``) builds over ranks that do not exist and every
collective returns at once. Params, optimizer state, batches and caches
are DTensors of meta tensors, laid out by ``sharding/partition.py``; the
step (an AdamW training step with ``remat`` and microbatches by
accumulation, a prefill, or one decode token against a ``seq_len``
cache) runs on them under ``op_analysis.OpCounter``, which books each
rank-0 local operator. So the record is per device:

* ``ok``, ``mesh``, ``n_devices``, ``lower_s`` (build and trace time);
* ``memory``: the bytes live before the step (``argument_bytes``), the
  step's peak, and whether that fits the H100's 80 GB; where a loop over
  time was traced once (``trips.scan``: the sLSTM), ``loop_traced_once``
  is its trip count and the peak holds one trip's intermediates, so it
  understates a training step's (0 where no loop was);
* ``flops``, ``bytes``, ``collectives`` (count and bytes by op),
  ``roofline`` (``op_analysis.roofline_terms``), ``kernels`` (the port's
  kernel calls), ``devices`` (of every tensor made off the host: only
  ``meta``) and ``host_bytes_max`` (the largest floating-point one made on
  the host);
* ``params_total``, ``params_active``, ``model_flops_per_device`` (6 or 2
  x active params x tokens / devices) and ``useful_flop_ratio``.

The JAX record's ``while_trips`` (XLA's loop trip counts) and
``xla_cost_analysis`` have no meaning in torch, and are absent.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import prng
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import get_api
from repro_torch.models.model import active_param_count, param_count
from repro_torch.optim import adamw
from repro_torch.sharding import partition as part
from repro_torch.tree import tree_leaves, tree_map

# The JAX package's best-known settings per family (``--tuned``), as
# configuration: its measured times are a TPU's and are not carried over.
TUNED_TRAIN = {
    "zamba2-7b": {"ssm_chunk": 128, "activation_shard": "dmodel", "microbatches": 4},
    "xlstm-1.3b": {"ssm_chunk": 512, "activation_shard": "dmodel", "microbatches": 4},
    "qwen1.5-110b": {"activation_shard": "dmodel", "microbatches": 4},
    "qwen3-0.6b": {"activation_shard": "dmodel"},
    "qwen2-moe-a2.7b": {"pad_experts_to": 64, "microbatches": 2},
}
TUNED_DECODE_MLA = {"mla_absorb": True, "mla_cache_shard": "seq"}
TUNED_PREFILL = {
    "qwen2-moe-a2.7b": {"pad_experts_to": 64},
    "zamba2-7b": {"ssm_chunk": 128},
}
META = torch.device("meta")


def tuned_overrides_for(arch: str, shape_name: str) -> dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "train":
        return dict(TUNED_TRAIN.get(arch, {}))
    if shape.kind == "prefill":
        return dict(TUNED_PREFILL.get(arch, {}))
    if shape.kind == "decode" and cfg.use_mla:
        return dict(TUNED_DECODE_MLA)
    return {}


def tuned_config(arch: str, shape_name: str, overrides=None, base=None):
    """Dry-run configuration: bf16 params, remat for training, grouped MoE
    dispatch, sliding-window KV for the 500k decode shape. ``base`` (a
    config) stands in for the registry's ``arch``, as the tests' smoke
    configs do."""
    cfg = base if base is not None else get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    kw = dict(param_dtype="bfloat16")
    if shape.kind == "train":
        kw["remat"] = True
    if cfg.is_moe:
        # dispatch groups aligned with the data-parallel degree, so each
        # group's top-C selection stays local to one mesh row
        kw["moe_groups"] = 16 if shape.global_batch % 16 == 0 and shape.global_batch > 1 else 1
    if shape_name == "long_500k" and cfg.arch_type != "ssm":
        kw["sliding_window"] = 4096
    if overrides:
        kw.update(overrides)
    return cfg.replace(**kw), shape


def fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks in this process, this
    process rank 0 (one that already has that size is kept)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _on_mesh(t, mesh, spec):
    """``t`` laid out on ``mesh`` by ``spec``; ``t`` itself without a mesh."""
    return t if mesh is None else distribute_tensor(t, mesh, part.placements(mesh, spec))


def batch_specs(cfg, shape, mesh) -> dict:
    """The model inputs of a training step or a prefill, as meta DTensors
    laid out by ``partition.batch_spec``."""
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.param_dtype)
    S_text = S - cfg.n_img_tokens if cfg.arch_type == "vlm" else S
    batch = {"tokens": torch.empty(B, S_text, dtype=torch.int64, device=META),
             "labels": torch.empty(B, S_text, dtype=torch.int64, device=META)}
    if shape.kind == "train":
        batch["client_weights"] = torch.empty(B, dtype=torch.float32, device=META)
    if cfg.arch_type == "vlm":
        batch["img_embeds"] = torch.empty(B, cfg.n_img_tokens, cfg.d_model, dtype=dt, device=META)
    if cfg.arch_type == "audio":
        batch["frames"] = torch.empty(B, cfg.enc_frames, cfg.d_model, dtype=dt, device=META)
    return {k: _on_mesh(v, mesh, mesh and part.batch_spec(mesh, B, v.ndim))
            for k, v in batch.items()}


def param_sds(api, cfg, mesh):
    """(plain meta params, the same as DTensors of ``mesh``, or plain
    without a mesh)."""
    plain = api.init_params(prng.PRNGKey(0, device=META), cfg, device=META)
    if mesh is None:
        return plain, plain
    return plain, part.distribute_tree(plain, part.tree_param_specs(plain, cfg), mesh)


def cache_sds(api, cfg, plain_params, mesh, batch_size, length):
    """Empty decode caches of ``length`` slots, as meta DTensors laid out
    by ``partition.cache_spec``."""
    caches = api.init_cache_fn(plain_params, cfg, batch_size, length,
                               getattr(torch, cfg.param_dtype))
    return caches if mesh is None else part.distribute_caches(caches, mesh, batch_size)


def setup_ctx(cfg, mesh) -> None:
    part.clear_sharding_ctx()
    part.set_axis_sizes(mesh)
    dp = part.dp_axes(mesh)
    act = {"seq": part.P(dp, "model", None), "dmodel": part.P(dp, None, "model"),
           "none": None}[cfg.activation_shard]
    kw = {"logits": (mesh, part.P(dp, None, "model")), "mla_cache_shard": cfg.mla_cache_shard}
    if act is not None:
        kw["activation"] = (mesh, act)
    part.set_sharding_ctx(**kw)


def _microbatches(batch: dict, n: int) -> list:
    """``n`` microbatches of a batch split by rows: each rank's local rows
    cut in ``n``, so no collective moves them."""
    def cut(t, k):
        if not isinstance(t, DTensor):
            m = t.shape[0] // n
            return t[k * m:(k + 1) * m]
        loc = t.to_local()
        m = loc.shape[0] // n
        shape = (t.shape[0] // n, *t.shape[1:])
        return DTensor.from_local(loc[k * m:(k + 1) * m], t.device_mesh, t.placements,
                                  run_check=False, shape=shape,
                                  stride=torch.empty(shape, device=META).stride())

    return [{key: cut(t, k) for key, t in batch.items()} for k in range(n)]


def build_step(cfg, shape, mesh):
    """Returns (step, args, plain meta params) for ``cfg`` at ``shape`` on
    ``mesh``; ``step(*args)`` runs the training step, the prefill or the
    decode step on meta DTensors (on plain meta tensors for ``mesh``
    None: the plain step)."""
    api = get_api(cfg)
    if mesh is not None:
        setup_ctx(cfg, mesh)
    plain, params = param_sds(api, cfg, mesh)

    if shape.kind == "train":
        opt = adamw(lr=1e-4)
        opt_state = opt.init(params)
        batch = batch_specs(cfg, shape, mesh)

        def grads_of(p, b):
            leaves = tree_leaves(p)
            loss = api.loss_fn(p, cfg, b)[0]
            return loss, torch.autograd.grad(loss, leaves)

        def train_step(params, opt_state, batch):
            p = tree_map(lambda t: t.detach().requires_grad_(), params)
            if cfg.microbatches > 1:
                n = cfg.microbatches
                acc, losses = None, []
                for mb in _microbatches(batch, n):
                    loss, gs = grads_of(p, mb)
                    gs = [g.to(torch.float32) for g in gs]
                    acc = gs if acc is None else [a + g for a, g in zip(acc, gs)]
                    losses.append(loss.detach())
                grads = [(a / n).to(t.dtype) for a, t in zip(acc, tree_leaves(p))]
                loss = torch.stack(losses).mean()
            else:
                loss, grads = grads_of(p, batch)
            it = iter(grads)
            with torch.no_grad():
                new_p, new_o = opt.update(tree_map(lambda t: t.detach(), p),
                                          tree_map(lambda _: next(it), p), opt_state)
            return loss.detach(), new_p, new_o

        return train_step, (params, opt_state, batch), plain

    if shape.kind == "prefill":
        batch = batch_specs(cfg, shape, mesh)

        @torch.no_grad()
        def prefill_step(params, batch):
            return api.prefill_fn(params, cfg, batch)

        return prefill_step, (params, batch), plain

    # decode: one token against a seq_len cache
    B, S = shape.global_batch, shape.seq_len
    cache_len = min(S, cfg.sliding_window) if cfg.sliding_window else S
    caches = cache_sds(api, cfg, plain, mesh, B, cache_len)
    token = _on_mesh(torch.empty(B, 1, dtype=torch.int64, device=META), mesh,
                     mesh and part.batch_spec(mesh, B, 2))

    @torch.no_grad()
    def decode_step(params, caches, token, position):
        return api.decode_fn(params, cfg, token, position, caches)

    return decode_step, (params, caches, token, S - 1), plain


def model_costs(cfg, shape, n_devices: int, plain_params=None) -> dict:
    """Params (all, and active per token) and the model-level useful flops
    per device, 6 (training) or 2 x active params x tokens / devices."""
    if plain_params is None:
        plain_params = get_api(cfg).init_params(prng.PRNGKey(0, device=META), cfg, device=META)
    n_active = active_param_count(plain_params, cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    factor = 6 if shape.kind == "train" else 2
    return {"params_total": int(param_count(plain_params)), "params_active": int(n_active),
            "model_flops_per_device": factor * n_active * tokens / n_devices}


def run_dryrun(arch: str, shape_name: str, multi_pod: bool = False, overrides=None,
               base=None, mesh=None) -> dict:
    """One combination's record (see the module). Needs a process group of
    at least the mesh's size (``fake_group``); ``mesh`` replaces the
    production mesh and ``base`` the registry's config (the tests' small
    meshes and smoke configs)."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = math.prod(mesh.shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": "x".join(map(str, mesh.shape)),
           "n_devices": int(n_dev), "ok": False}
    if overrides:
        rec["overrides"] = {k: str(v) for k, v in overrides.items()}
    try:
        t0 = time.time()
        cfg, shape = tuned_config(arch, shape_name, overrides, base)
        counter = op_analysis.OpCounter()
        with part.use_mesh(mesh):
            fn, args, plain = build_step(cfg, shape, mesh)
            counter.track(args)
            argument_bytes = counter.live
            with counter:
                out = fn(*args)
            del out
        rec["lower_s"] = round(time.time() - t0, 2)
        s = counter.summary()
        rec["memory"] = {"argument_bytes": argument_bytes, "peak_bytes": s["peak_bytes"],
                         "device_bytes": op_analysis.DEVICE_BYTES,
                         "fits": s["peak_bytes"] <= op_analysis.DEVICE_BYTES,
                         "loop_traced_once": s["looped"]}
        rec.update({k: s[k] for k in ("flops", "bytes", "collectives", "kernels", "devices",
                                      "host_bytes_max")})
        rec["roofline"] = op_analysis.roofline_terms(s["flops"], s["bytes"],
                                                     s["collectives"]["total_bytes"])
        rec.update(model_costs(cfg, shape, n_dev, plain))
        rec["useful_flop_ratio"] = rec["model_flops_per_device"] / max(rec["flops"], 1.0)
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 - the record carries the failure
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    finally:
        part.clear_sharding_ctx()
    return rec


def parse_overrides(items) -> dict:
    out = {}
    for ov in items:
        k, _, v = ov.partition("=")
        out[k] = json.loads(v) if v[:1] in "0123456789tf[{\"" else v
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None, help="write JSON here")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (e.g. mla_absorb=true)")
    ap.add_argument("--tuned", action="store_true",
                    help="apply the JAX package's best-known settings per family")
    args = ap.parse_args(argv)
    overrides = tuned_overrides_for(args.arch, args.shape) if args.tuned else {}
    overrides.update(parse_overrides(args.override))
    fake_group(512 if args.multi_pod else 256)
    rec = run_dryrun(args.arch, args.shape, args.multi_pod, overrides or None)
    js = json.dumps(rec, indent=2, default=str)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js)
    print(js)
    if not rec["ok"]:
        raise SystemExit(1)
    print(f"\nOK {args.arch} x {args.shape} mesh={rec['mesh']} flops/dev={rec['flops']:.3e} "
          f"coll={rec['collectives']['total_bytes']:.3e}B "
          f"peak={rec['memory']['peak_bytes'] / 2**30:.2f}GiB "
          f"bottleneck={rec['roofline']['bottleneck']} ({rec['lower_s']}s)")
    return rec


if __name__ == "__main__":
    main()
