"""The reference of an MMFL round of the ``arch`` task family: the
alpha-fair allocation (the paper's Eq. 4), the synthetic client shards
and each round's batches, a tau > 1 task's local SGD rows folded by the
weighted mean, a tau = 1 task's AdamW server step, and the eval probe.

The draws are numpy's, in the order the system under test makes them: the
coordinator's generator and the batch generator are both seeded with the
scenario's seed; a task's shards with the run's seed plus its index.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field

import numpy as np
import torch

from perfbench.reference.common import F32, Draw, leaves, tree_map

LOCAL_LR = 5e-3
ADAMW = dict(lr=3e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01, max_grad_norm=1.0)


def family(cfg):
    """The reference module of ``cfg``'s family: ``reference/<arch_type>.py``."""
    return importlib.import_module(f"perfbench.reference.{cfg.arch_type}")


def weights(cfg, seed: int, device):
    """One model's weights, drawn from ``seed`` on ``device``."""
    return family(cfg).init(Draw(seed, device), cfg)


def alpha_fair(losses, alpha) -> np.ndarray:
    """Eq. 4: p_s proportional to loss_s^(alpha - 1), in f32 log space."""
    f32 = np.float32
    logf = np.log(np.maximum(np.asarray(losses, f32), f32(1e-12))) * f32(alpha - 1.0)
    e = np.exp(logf - logf.max())
    return e / e.sum()


@dataclass
class Allocator:
    """The coordinator's allocation: each round ``participation * K``
    clients drawn without replacement, each then drawing its task from
    Eq. 4 on the prevailing losses (uniform until a loss is known)."""

    n_tasks: int
    n_clients: int
    participation: float
    alpha: float
    seed: int
    losses: list = field(default_factory=list)

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        self.losses = [float("inf")] * self.n_tasks

    def probs(self) -> np.ndarray:
        losses = np.maximum(np.array(self.losses), 1e-6)
        finite = np.isfinite(losses)
        if not finite.any():
            return np.ones(self.n_tasks) / self.n_tasks
        losses = np.where(finite, losses, losses[finite].max())
        return alpha_fair(losses, self.alpha)

    def next_round(self) -> list:
        """The client ids of each task, in draw order."""
        p = self.probs()
        m = max(1, int(round(self.participation * self.n_clients)))
        out = [[] for _ in range(self.n_tasks)]
        for i in self.rng.choice(self.n_clients, size=m, replace=False):
            out[self.rng.choice(self.n_tasks, p=p / p.sum())].append(i)
        return [np.array(v, np.int64) for v in out]


def dataset(vocab: int, n_clients: int, shards: int, seq: int, seed: int) -> np.ndarray:
    """(K, shards, seq) int32 tokens; each client draws uniformly from a
    band of half the vocabulary that starts at a random offset."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_clients):
        lo = rng.integers(0, max(1, vocab // 2))
        hi = min(vocab, lo + vocab // 2)
        out.append(rng.integers(lo, hi, size=(shards, seq)).astype(np.int32))
    return np.stack(out)


def features(cfg, toks) -> dict:
    """Model inputs of token rows: a vlm's zero image embeddings ahead of
    its text ``toks[..., :seq - n_img_tokens]``; an audio model's zero
    frames."""
    batch = {"tokens": toks, "labels": toks}
    if cfg.arch_type == "vlm":
        text = toks[..., :toks.shape[-1] - cfg.n_img_tokens]
        batch = {"tokens": text, "labels": text,
                 "img_embeds": torch.zeros(*toks.shape[:-1], cfg.n_img_tokens, cfg.d_model,
                                           device=toks.device)}
    if cfg.arch_type == "audio":
        batch["frames"] = torch.zeros(*toks.shape[:-1], cfg.enc_frames, cfg.d_model,
                                      device=toks.device)
    return batch


def assemble(cfg, B: int, seq: int, data, ids, n_clients: int, rng, device) -> dict:
    """A round's batch: B rows tiled over the task's clients, one random
    shard each; the clients' uniform weights tiled and normalised per row;
    an audio model's frames 0.02 * N(0, 1), drawn after the shards."""
    reps = int(np.ceil(B / max(len(ids), 1)))
    rows = np.tile(ids, reps)[:B]
    shard = rng.integers(0, data.shape[1], size=B)
    toks = torch.from_numpy(np.asarray(data[rows, shard][:, :seq] % cfg.vocab_size,
                                       np.int64)).to(device)
    w = np.full(len(ids), 1.0 / n_clients)
    w = (w / max(w.sum(), 1e-12)).astype(np.float32)
    w_rows = np.tile(w, reps)[:B]
    w_rows = w_rows / max(w_rows.sum(), 1e-9)
    batch = features(cfg, toks)
    if cfg.arch_type == "audio":
        frames = rng.standard_normal((B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        batch["frames"] = torch.from_numpy(frames * np.float32(0.02)).to(device)
    batch["client_weights"] = torch.from_numpy(np.asarray(w_rows, np.float32)).to(device)
    return batch


def loss_and_grads(cfg, params, batch):
    flat = leaves(params)
    req = {path: t.detach().requires_grad_(True) for path, t in flat}
    tree = _rebuild(params, req)
    loss = family(cfg).loss(tree, cfg, batch)
    grads = torch.autograd.grad(loss, [req[p] for p, _ in flat])
    return loss.detach(), _rebuild(params, {p: g for (p, _), g in zip(flat, grads)})


def _rebuild(template, by_path, prefix=""):
    if isinstance(template, dict):
        return {k: _rebuild(v, by_path, f"{prefix}/{k}" if prefix else k)
                for k, v in template.items()}
    return by_path[prefix]


def adamw_step(params, grads, state):
    """AdamW with the gradients clipped to a global norm of 1 (the sum of
    squares taken leaf by leaf in sorted key order). Returns (params,
    state, the clipped gradients)."""
    h = ADAMW
    gn = torch.sqrt(sum(g.to(F32).square().sum() for _, g in leaves(grads)))
    scale = torch.clamp(h["max_grad_norm"] / torch.clamp(gn, min=1e-9), max=1.0)
    grads = tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads)
    count = state["count"] + 1
    c = count.to(F32)
    bc1, bc2 = 1.0 - h["b1"] ** c, 1.0 - h["b2"] ** c

    def one(p, g, mu, nu):
        g32 = g.to(F32)
        mu = h["b1"] * mu + (1 - h["b1"]) * g32
        nu = h["b2"] * nu + (1 - h["b2"]) * g32.square()
        step = (mu / bc1) / (torch.sqrt(nu / bc2) + h["eps"]) + h["weight_decay"] * p.to(F32)
        return ((p.to(F32) - h["lr"] * step).to(p.dtype), mu, nu)

    out = tree_map(one, params, grads, state["mu"], state["nu"])
    pick = [tree_map(lambda o, i=i: o[i], out) for i in range(3)]
    return pick[0], {"mu": pick[1], "nu": pick[2], "count": count}, grads


def adamw_init(params):
    leaf = leaves(params)[0][1]
    return {"mu": tree_map(lambda p: torch.zeros_like(p, dtype=F32), params),
            "nu": tree_map(lambda p: torch.zeros_like(p, dtype=F32), params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def sgd_rows(cfg, params, batch, tau: int):
    """Each row's tau SGD steps from ``params``, folded on the fly into the
    weighted mean sum_k w_k p_k / sum_k w_k. Returns (mean params, mean of
    the rows' losses, the gradients of the first row's first step)."""
    w = batch["client_weights"]
    norm = torch.clamp(w.sum(), min=1e-9)
    acc = tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)
    row_losses, first = [], None
    for i in range(w.shape[0]):
        row = {k: v[i:i + 1] for k, v in batch.items() if k != "client_weights"}
        p, losses = params, []
        for _ in range(tau):
            loss, g = loss_and_grads(cfg, p, row)
            first = g if first is None else first
            p = tree_map(lambda pp, gg: (pp - LOCAL_LR * gg).to(pp.dtype), p, g)
            losses.append(loss)
        acc = tree_map(lambda a, pp: a.add_(pp.to(F32) * (w[i] / norm)), acc, p)
        row_losses.append(torch.stack(losses).mean())
        del p
    new = tree_map(lambda a, p0: a.to(p0.dtype), acc, params)
    return new, torch.stack(row_losses).mean(), first


def norms(tree) -> dict:
    """The l2 norm of each leaf, by path."""
    return {path: float(torch.linalg.vector_norm(t.to(F32))) for path, t in leaves(tree)}


def weight_seed(seed: int, task_index: int) -> int:
    """The seed of task ``task_index``'s weights in a run of ``seed``."""
    return (seed << 8) + task_index


def probe_batch(cfg, data, device):
    """The eval probe: the first shard of up to 8 clients, all but the last
    token in, the last token the target."""
    toks = torch.from_numpy(np.asarray(data[:min(8, data.shape[0]), 0] % cfg.vocab_size,
                                       np.int64)).to(device)
    feats = features(cfg, toks)
    return dict(feats, tokens=feats["tokens"][:, :-1], labels=feats["labels"][:, :-1])


def follow(tasks, scenario: dict, seed: int, device, rounds: int, tf32: bool = False) -> dict:
    """The first ``rounds`` rounds of a run of ``seed``, in plain PyTorch.

    ``tasks``: dicts with ``cfg`` (a ``common.ModelConfig``), ``tau``,
    ``batch``, ``seq`` and ``shards``; ``scenario``: ``seed`` (the
    allocation's and the batches' draws), ``n_clients``,
    ``participation``, ``alpha``. The shards and the weights follow
    ``seed``. f32 matmuls with TF32 off, or with it on
    where ``tf32`` (the control). Returns per round the task of each client
    (-1 for none), each task's reported loss (None where it had no
    clients) and each task's probe logits (8, V); per task the per-leaf
    norms of its first gradient (a tau = 1 task's as AdamW gets it, after
    the clip; a tau > 1 task's first row's first step) and of its change
    over the rounds."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _follow(tasks, scenario, seed, torch.device(device), rounds)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _follow(tasks, scenario, seed, device, rounds):
    K = scenario["n_clients"]
    alloc = Allocator(len(tasks), K, scenario["participation"], scenario["alpha"],
                      scenario["seed"])
    rng = np.random.default_rng(scenario["seed"])
    data = [dataset(t["cfg"].vocab_size, K, t["shards"], t["seq"], seed + s)
            for s, t in enumerate(tasks)]
    params = [weights(t["cfg"], weight_seed(seed, s), device) for s, t in enumerate(tasks)]
    opt = [adamw_init(p) if t["tau"] <= 1 else None for p, t in zip(params, tasks)]
    probes = [probe_batch(t["cfg"], d, device) for t, d in zip(tasks, data)]
    out = {"alloc": [], "loss": [], "probe": [], "first_grad": [None] * len(tasks)}
    for _ in range(rounds):
        ids = alloc.next_round()
        row, losses = [-1] * K, [None] * len(tasks)
        for s, t in enumerate(tasks):
            if len(ids[s]) == 0:
                continue
            for i in ids[s]:
                row[i] = s
            cfg = t["cfg"]
            batch = assemble(cfg, t["batch"], t["seq"], data[s], ids[s], K, rng, device)
            if t["tau"] <= 1:
                loss, g = loss_and_grads(cfg, params[s], batch)
                params[s], opt[s], g = adamw_step(params[s], g, opt[s])
            else:
                params[s], loss, g = sgd_rows(cfg, params[s], batch, t["tau"])
            if out["first_grad"][s] is None:
                out["first_grad"][s] = norms(g)
            del g
            losses[s] = alloc.losses[s] = float(loss)
        with torch.no_grad():
            out["probe"].append([family(t["cfg"]).last_logits(p, t["cfg"], b).to(F32)
                                 for t, p, b in zip(tasks, params, probes)])
        out["alloc"].append(row)
        out["loss"].append(losses)
    out["change"] = []
    for s, t in enumerate(tasks):
        p0 = weights(t["cfg"], weight_seed(seed, s), device)
        out["change"].append(norms(tree_map(lambda a, b: a.to(F32) - b.to(F32), params[s], p0)))
        del p0
    return out
