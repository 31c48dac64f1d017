"""MMFL training launcher: concurrent fair training of several LM
architectures with FedFairMMFL client-task allocation.

The port's counterpart of the JAX package's ``launch/train.py``: the
``arch`` task family's building blocks (synthetic non-iid token shards,
the cohort update rules, the fused AdamW server step, the eval probe, the
async adapter) and a thin CLI over the scenario API. Flags (or a ``--spec
scenario.json`` file) build a ``ScenarioSpec``, and
``repro_torch.api.run_scenario`` drives the sync round loop or the async
FedAST engine.

Numpy draws (data, batches) are the reference's, in the same order; model
init draws from ``repro_torch.prng`` as the reference draws from
``jax.random``. Gradients come from ``torch.autograd``. Where the
reference ``jax.jit``s and ``lax.scan``s, the port runs eagerly and loops
in Python: each cohort row's τ steps, then the next row.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --spec examples/specs/tiny_two_task.json --device cpu

``--device`` defaults to CUDA, and raises without a card.
"""
from __future__ import annotations

import argparse
import json
import zlib

import numpy as np
import torch

from repro_torch import prng
from repro_torch.api import (AllocationSpec, ClientPopulationSpec, PolicySpec, RuntimeSpec,
                             ScenarioSpec, TaskSpec)
from repro_torch.api.backend import ClientBatch, CohortTask, get_backend
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.allocation import AllocationStrategy
from repro_torch.device import resolve_device
from repro_torch.fed.trainer import task_round_key
from repro_torch.models import get_api
from repro_torch.models.transformer import check_ported
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def make_dataset(key, cfg, n_clients, shards_per_client, seq, seed=0):
    """Synthetic per-client token shards with client-specific structure, so
    losses are heterogeneous across clients (non-iid). numpy, bit-equal to
    the reference's."""
    del key
    rng = np.random.default_rng(seed)
    vocab = cfg.vocab_size
    data = []
    for _ in range(n_clients):
        # each client prefers a vocabulary band (non-iid)
        lo = rng.integers(0, max(1, vocab // 2))
        hi = min(vocab, lo + vocab // 2)
        toks = rng.integers(lo, hi, size=(shards_per_client, seq))
        data.append(toks.astype(np.int32))
    return np.stack(data)           # (K, shards, seq)


def arch_features(cfg, toks):
    """Model-input dict from token rows, on any leading batch shape, as in
    the reference: a vlm's image embeddings are zeros (B..., n_img_tokens,
    d_model) and its tokens and labels ``toks[..., :seq - n_img_tokens]``
    (see ``_image_inputs``); an audio model's frames are zeros (B...,
    enc_frames, d_model)."""
    check_ported(cfg)
    batch = {"tokens": toks, "labels": toks}
    if cfg.arch_type == "vlm":
        batch.update(_image_inputs(cfg, toks))
    if cfg.arch_type == "audio":
        batch["frames"] = torch.zeros(*toks.shape[:-1], cfg.enc_frames, cfg.d_model,
                                      device=toks.device)
    return batch


def _image_inputs(cfg, toks) -> dict:
    """A vlm's zero image embeddings and its text, sliced as the reference
    slices it: ``toks[..., :seq - n_img_tokens]``. That is seq -
    n_img_tokens tokens for seq > n_img_tokens, and none (a loss of 0) at
    seq == n_img_tokens or seq <= n_img_tokens / 2. In between the slice
    end is negative and keeps 2 * seq - n_img_tokens tokens, so the model
    sees 2 * seq positions, more than seq."""
    text = toks[..., :toks.shape[-1] - cfg.n_img_tokens]
    return {"img_embeds": torch.zeros(*toks.shape[:-1], cfg.n_img_tokens, cfg.d_model,
                                      device=toks.device),
            "tokens": text, "labels": text}


def _tokens(toks: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(toks, np.int64)).to(device)


def loss_and_grads(api, cfg, params, batch):
    """``jax.value_and_grad(api.loss_fn, has_aux=True)``: (loss, grads),
    both detached."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, _ = api.loss_fn(tree_unflatten(params, leaves), cfg, batch)
    return loss.detach(), tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))


def arch_local_fn(api, cfg, tau: int, local_lr: float):
    """The cohort's local FedAvg work for an arch task: each row runs
    ``tau`` SGD steps ``p - lr*g`` on its batch from the global params.
    ``local_fn(params, keys, batch) -> (updates, losses)`` in the port's
    cohort contract (``api/backend.py``): ``batch`` holds one batch per
    row along a leading K axis; the updated params stack along that axis
    and each row's loss is the mean of its ``tau`` per-step losses.
    Deterministic given the batch (the keys are unused). Rows run in
    cohort order, each row's graphs freed before the next starts."""

    def row_update(params, batch):
        p, losses = params, []
        for _ in range(tau):
            loss, g = loss_and_grads(api, cfg, p, batch)
            p = tree_map(lambda pp, gg: (pp - local_lr * gg).to(pp.dtype), p, g)
            losses.append(loss)
        return p, torch.stack(losses).mean()

    def local_fn(params, keys, batch):
        del keys
        K = tree_leaves(batch)[0].shape[0]
        out = tree_map(lambda t: t.new_empty((K, *t.shape)), params)
        losses = []
        for i in range(K):
            p, loss = row_update(params, tree_map(lambda t: t[i], batch))
            tree_map(lambda o, t: o[i].copy_(t), out, p)
            losses.append(loss)
        return out, torch.stack(losses)

    return local_fn


def arch_shard_local_fn(api, cfg, tau: int, local_lr: float):
    """``arch_local_fn`` over clients' raw token shards (the async
    adapter's unit of work): the features are built inside, so the cohort
    input is the (n, shards, seq) token tensor."""
    rows_fn = arch_local_fn(api, cfg, tau, local_lr)

    def local_fn(params, keys, toks):
        return rows_fn(params, keys, arch_features(cfg, toks))

    return local_fn


def make_arch_eval(task, data):
    """Eval pair for an arch task on a held-out shard: (loss, next-token
    top-1 accuracy), each a function of the params returning a float. The
    shard is the first one of up to 8 clients (tokens the clients also
    train on, as in the reference); the probe prefills all but the last
    token and predicts the last."""
    cfg, api, dev = task["cfg"], task["api"], task["device"]
    n_eval = min(8, data.shape[0])
    toks = _tokens(data[:n_eval, 0] % cfg.vocab_size, dev)
    feats = arch_features(cfg, toks)
    probe = dict(feats, tokens=feats["tokens"][:, :-1], labels=feats["labels"][:, :-1])
    target = feats["tokens"][:, -1]

    @torch.no_grad()
    def eval_loss(params) -> float:
        return float(api.loss_fn(params, cfg, feats)[0])

    @torch.no_grad()
    def eval_acc(params) -> float:
        logits, _ = api.prefill_fn(params, cfg, probe)
        pred = torch.argmax(logits[:, -1, :], dim=-1)
        return float((pred == target).to(torch.float32).mean())

    return eval_loss, eval_acc


def server_opt():
    """The arch tasks' server optimizer: one definition for ``build_task``
    (state init) and ``arch_fused_step`` (the update rule)."""
    return adamw(lr=3e-3, max_grad_norm=1.0)


def arch_fused_step(api, cfg):
    """tau=1 local steps == weighted gradient aggregation (core/mmfl): ONE
    AdamW server step on the mixed p_k-weighted batch. Returns
    (train_step, opt_local_fn); the latter wraps the step as a single-unit
    cohort whose state is the (params, opt) pair, so the engine dispatches
    it through the same ExecutionBackend seam."""
    opt = server_opt()

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(api, cfg, params, batch)
        new_p, new_o = opt.update(params, grads, opt_state)
        return loss, new_p, new_o

    def opt_local_fn(state, keys, batch):
        del keys
        params_, opt_ = state
        loss, new_p, new_o = train_step(params_, opt_, tree_map(lambda t: t[0], batch))
        return tree_map(lambda t: t[None], (new_p, new_o)), loss[None]

    return train_step, opt_local_fn


def build_task(arch: str, preset: str, seq: int, batch: int, tau: int = 1,
               local_lr: float = 5e-3, device=None):
    """One arch task on ``device`` (None means CUDA): its config (the SSM
    chunk cut to a quarter of the sequence, at least 8), params drawn from
    ``PRNGKey(crc32(arch) % 2**31)``, the AdamW state, and its update
    rules."""
    dev = resolve_device(device)
    cfg = smoke_config(arch) if preset == "tiny" else get_config(arch)
    cfg = cfg.replace(ssm_chunk=min(cfg.ssm_chunk, max(8, seq // 4)))
    api = get_api(cfg)
    # crc32 (not hash()) keying: independent of PYTHONHASHSEED
    params = api.init_params(prng.PRNGKey(zlib.crc32(arch.encode()) % 2**31, device=dev), cfg,
                             device=dev)
    opt_state = server_opt().init(params)
    # tau > 1 is TRUE FedAvg: each cohort row runs tau local SGD steps from
    # the global params, and the engine folds them through the backend
    train_step, opt_local_fn = arch_fused_step(api, cfg) if tau <= 1 else (None, None)
    return {"cfg": cfg, "api": api, "params": params, "opt": opt_state,
            "step": train_step, "tau": tau,
            "local_fn": arch_local_fn(api, cfg, max(tau, 1), local_lr),
            "opt_local_fn": opt_local_fn,
            "batch": batch, "seq": seq, "device": dev}


def assemble_batch(task, data, client_ids, weights, rng):
    """The task's batch for one round: ``batch`` rows tiled over the
    selected clients, one random shard each (numpy draws in the
    reference's order), with the p_k weights per row normalised into
    ``client_weights``; a vlm's zero image embeddings and text, as
    ``arch_features`` makes them; an audio model's frames ``0.02 *
    standard_normal`` (B, enc_frames, d_model) in f32, drawn after the
    shards from the same generator, as in the reference."""
    cfg = task["cfg"]
    B, seq = task["batch"], task["seq"]
    reps = int(np.ceil(B / max(len(client_ids), 1)))
    rows = np.tile(client_ids, reps)[:B]
    shard_ix = rng.integers(0, data.shape[1], size=B)
    toks = _tokens(data[rows, shard_ix][:, :seq] % cfg.vocab_size, task["device"])
    w = np.asarray(weights)
    w_rows = np.tile(w, reps)[:B]
    w_rows = w_rows / max(w_rows.sum(), 1e-9)
    batch = {"tokens": toks, "labels": toks}
    batch["client_weights"] = torch.from_numpy(
        np.asarray(w_rows, np.float32)).to(task["device"])
    if cfg.arch_type == "vlm":
        batch.update(_image_inputs(cfg, toks))
    if cfg.arch_type == "audio":
        frames = rng.standard_normal((B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        batch["frames"] = torch.from_numpy(frames * np.float32(0.02)).to(task["device"])
    return batch


class ArchAsyncTask:
    """AsyncTask adapter for one architecture: tau local SGD steps on the
    completing client's token shards, exposed as ``local_fn`` +
    ``client_batch`` so the async engine's flushes dispatch through the
    ExecutionBackend like the synthetic tasks'."""

    def __init__(self, name, task_idx, task, data, tau=2, local_lr=5e-3):
        self.name = name
        self.task_idx = task_idx
        self.task = task
        self.data = data                      # (K, shards, seq)
        self.n_clients = data.shape[0]
        self.p_k = np.ones(self.n_clients) / self.n_clients
        self.work = 1.0
        self._cfg = task["cfg"]
        self.device = task["device"]
        # a client's "batch" is its full shard stack (shards, seq)
        self.local_fn = arch_shard_local_fn(task["api"], self._cfg, tau, local_lr)
        self._eval, self._eval_acc = make_arch_eval(task, data)

    def init(self, seed):
        del seed
        return self.task["params"]

    def client_batch(self, seed, version, client_ids) -> ClientBatch:
        ids = np.asarray(client_ids, np.int64)
        keys = prng.fold_in(task_round_key(seed, self.task_idx, version), torch.from_numpy(ids))
        return ClientBatch(ids, keys, (_tokens(self.data[ids] % self._cfg.vocab_size,
                                               self.device),))

    def update(self, params, seed, version, client_ids):
        return get_backend("vmap", self.device).run_cohort(
            CohortTask(self.name, params, self.local_fn),
            self.client_batch(seed, version, client_ids)).updates

    def evaluate(self, params) -> float:
        return self._eval(params)

    def accuracy(self, params) -> float:
        """Next-token top-1 accuracy on the held-out shard (the arch
        family's analogue of the synthetic tasks' test accuracy)."""
        return self._eval_acc(params)


def build_scenario(args) -> ScenarioSpec:
    """Map the CLI flags onto a ScenarioSpec."""
    archs = args.archs.split(",")
    task_opts = {"preset": args.preset, "seq": args.seq, "batch": args.batch, "tau": args.tau}
    return ScenarioSpec(
        name="launch-train",
        seed=args.seed,
        data_seed=args.seed,
        tasks=[TaskSpec(name=a, family="arch", options=dict(task_opts)) for a in archs],
        clients=ClientPopulationSpec(
            n_clients=args.clients,
            participation=args.participation,
            speed_profile=args.speed_profile,
            speed_spread=args.speed_spread,
            arrival_process=args.arrival_process,
            population=args.population,
            population_options=json.loads(args.population_options)
            if args.population_options else {}),
        allocation=AllocationSpec(strategy=args.strategy, alpha=args.alpha),
        policy=PolicySpec(name=args.policy) if args.policy else None,
        runtime=RuntimeSpec(
            mode="async" if args.async_mode else "sync",
            backend=args.backend,
            rounds=args.rounds,
            tau=args.tau,
            total_arrivals=args.arrivals,
            buffer_size=args.buffer,
            beta=args.beta,
            buffer_controller=args.buffer_controller,
            aggregator=args.aggregator,
            aggregator_options=json.loads(args.aggregator_options)
            if args.aggregator_options else {},
            cost_model=args.cost_model,
            cost_model_options=json.loads(args.cost_model_options)
            if args.cost_model_options else {},
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            checkpoint_keep=args.checkpoint_keep,
            resume=args.resume))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", default=None,
                    help="ScenarioSpec JSON file; overrides all other flags")
    ap.add_argument("--device", default=None, help="torch device; default CUDA")
    ap.add_argument("--archs", default="smollm-135m,qwen3-0.6b")
    ap.add_argument("--preset", choices=["tiny", "full"], default="tiny")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--alpha", type=float, default=3.0)
    ap.add_argument("--strategy", default="fedfair",
                    choices=[s.value for s in AllocationStrategy])
    ap.add_argument("--policy", default=None,
                    help="stateful allocation policy (POLICIES key, e.g. ucb_bandit | "
                         "grad_norm); default: the legacy wrapper for --strategy")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--participation", type=float, default=0.5)
    ap.add_argument("--tau", type=int, default=1,
                    help=">1: true FedAvg with tau local steps per client")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="serial",
                    help="cohort execution backend (serial | vmap | sharded | registered "
                         "BACKENDS key)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="full-state checkpoints for both engines, in the JAX package's "
                         "layout: every N rounds (sync) or N flushes (async)")
    ap.add_argument("--checkpoint-every", "--ckpt-every", type=int, default=10,
                    dest="checkpoint_every",
                    help="rounds (sync) / flushes (async) between checkpoints")
    ap.add_argument("--ckpt-keep", type=int, default=3, dest="checkpoint_keep",
                    help="keep the newest N complete steps in --checkpoint-dir")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest complete step in --checkpoint-dir "
                         "(a resumed run continues as an uninterrupted one)")
    ap.add_argument("--async", action="store_true", dest="async_mode",
                    help="event-driven async engine (FedAST-style buffered staleness-aware "
                         "aggregation) instead of lockstep rounds")
    ap.add_argument("--arrivals", type=int, default=64,
                    help="async: client completions to process")
    ap.add_argument("--buffer", type=int, default=None,
                    help="async: aggregate every B arrivals per task (default: "
                         "backend-aware)")
    ap.add_argument("--beta", type=float, default=0.5,
                    help="async: staleness discount exponent")
    ap.add_argument("--aggregator", default=None,
                    help="server aggregation rule (fedavg | fedavgm | fedadam | fedyogi | "
                         "fedmedian | trimmed_mean | qfedavg); default: fedavg")
    ap.add_argument("--aggregator-options", default=None,
                    help="JSON dict of aggregator options, e.g. '{\"lr\": 0.1}'")
    ap.add_argument("--cost-model", default=None, dest="cost_model",
                    help="client cost model (constant | device_tiers | "
                         "lognormal_straggler | trace_replay); default: constant")
    ap.add_argument("--cost-model-options", default=None, dest="cost_model_options",
                    help="JSON dict of cost-model options")
    ap.add_argument("--buffer-controller", default=None,
                    help="async: adaptive per-task buffer sizing (static | "
                         "staleness_target | arrival_rate); default: static")
    ap.add_argument("--speed-profile", default="bimodal",
                    choices=["uniform", "bimodal", "lognormal"])
    ap.add_argument("--speed-spread", type=float, default=4.0)
    ap.add_argument("--arrival-process", default="always_on",
                    help="async availability plugin (always_on | bursty | poisson)")
    ap.add_argument("--population", default=None,
                    help="client population plugin (vectorized | registered POPULATIONS "
                         "key): struct-of-arrays per-client state for very large N")
    ap.add_argument("--population-options", default=None, dest="population_options",
                    help="JSON dict of population options, e.g. '{\"lazy_data\": true}' to "
                         "make synthetic client shards on first dispatch")
    return ap


def main(argv=None):
    """Run the CLI; returns the ``RunResult``."""
    from repro_torch.api import run_scenario
    from repro_torch.fed.async_engine import resolve_buffer_size

    args = _parser().parse_args(argv)
    spec = ScenarioSpec.load(args.spec) if args.spec else build_scenario(args)
    dev = resolve_device(args.device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    names = [t.name for t in spec.tasks]
    if spec.runtime.mode == "async":
        buf = resolve_buffer_size(spec.runtime.buffer_size, spec.runtime.backend, dev)
        print(f"ASYNC MMFL: {names} buffer={buf} "
              f"controller={spec.runtime.buffer_controller or 'static'} "
              f"aggregator={spec.runtime.aggregator or 'fedavg'} "
              f"cost_model={spec.runtime.cost_model or 'constant'} "
              f"beta={spec.runtime.beta} "
              f"profile={spec.clients.speed_profile} "
              f"arrival={spec.clients.arrival_process} "
              f"on {n_dev} {dev.type} device(s)")
    else:
        print(f"MMFL concurrent training: {names} "
              f"[backend={spec.runtime.backend} "
              f"aggregator={spec.runtime.aggregator or 'fedavg'}] on "
              f"{n_dev} {dev.type} device(s)")

    result = run_scenario(spec, verbose=True, device=dev)

    if result.mode == "async":
        print(f"processed {int(result.arrivals.sum())} arrivals "
              f"({len(result.time)} aggregations) in "
              f"{result.wall_time:.1f}s wall, "
              f"{result.virtual_time:.1f} virtual")
    print("final losses:", {n: round(v, 3) for n, v in result.final_loss.items()})
    return result


if __name__ == "__main__":
    main()
