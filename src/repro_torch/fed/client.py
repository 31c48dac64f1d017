"""Client-side local training: tau SGD steps for a whole cohort at once.

The per-task model is a small MLP (the paper's CNN stand-in at synthetic
scale), held as the JAX package holds it: a list of ``{"w", "b"}`` dicts.
Where the JAX package ``jax.vmap``s one client's update over a cohort, the
port writes the cohort axis out: the global params are copied once per
client into stacked (K, ...) tensors, the per-client losses are summed,
and one ``backward`` gives every client its own gradient (clients share
no parameters, so the sum has no cross terms).

The minibatch indices come from the clients' keys through
``repro_torch.prng`` and match ``jax.random`` bit for bit; a caller may
also pass them in (``idx``).
"""

from __future__ import annotations

import torch

from repro_torch import prng


def init_mlp(key, input_dim, hidden, n_classes, depth=2, device=None):
    """He-normal weights and zero biases, drawn as the JAX ``init_mlp``
    draws them. ``device=None`` keeps the tensors on the key's device."""
    device = key.device if device is None else device
    dims = [input_dim] + [hidden] * (depth - 1) + [n_classes]
    ks = prng.split(key, len(dims) - 1)
    params = []
    for k, (a, b) in zip(ks, zip(dims[:-1], dims[1:])):
        params.append({
            "w": (prng.normal(k, (a, b)) * (2.0 / a) ** 0.5).to(device),
            "b": torch.zeros(b, device=device),
        })
    return params


def mlp_apply(params, x):
    """Logits. Params may carry a leading cohort axis (w: (K, a, b),
    b: (K, b)); x is then (K, n, a)."""
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"].unsqueeze(-2)
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def mlp_loss(params, x, y, w):
    """Mask-weighted mean cross-entropy over the last sample axis; one
    loss per client for cohort-stacked params."""
    logits = mlp_apply(params, x)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long().unsqueeze(-1)).squeeze(-1)
    nll = logz - gold
    return (nll * w).sum(-1) / torch.clamp(w.sum(-1), min=1.0)


def accuracy(params, x, y):
    """Fraction of rows whose argmax logit is the label, as f32."""
    return (torch.argmax(mlp_apply(params, x), -1) == y).to(torch.float32).mean()


def minibatch_indices(keys, tau: int, batch_size: int, n: int):
    """The JAX ``local_update`` index stream: step t of the client with
    key k draws ``randint(split(k, tau)[t], (batch_size,), 0, n)``.
    keys (..., 2) -> (..., tau, batch_size) int64, on the keys' device."""
    return prng.randint(prng.split(keys, tau), (batch_size,), 0, n)


def cohort_local_update(global_params, keys, xs, ys, ws, tau: int, lr,
                        batch_size: int = 32, idx=None):
    """tau SGD steps for every client of a cohort, all from the same
    global params.

    keys: (K, 2) client keys; xs: (K, n, d), ys: (K, n), ws: (K, n)
    sample mask. ``idx`` (K, tau, batch_size) overrides the minibatch
    indices drawn from ``keys``. Returns the updated params, stacked with
    a leading K axis.
    """
    K, n = xs.shape[0], xs.shape[1]
    if idx is None:
        idx = minibatch_indices(keys, tau, batch_size, n)
    idx = idx.to(xs.device)
    rows = torch.arange(K, device=xs.device).unsqueeze(-1)
    params = [{name: p.detach().unsqueeze(0).expand(K, *p.shape).clone()
               for name, p in layer.items()} for layer in global_params]
    for t in range(tau):
        it = idx[:, t]
        leaves = [p.requires_grad_() for layer in params for p in layer.values()]
        with torch.enable_grad():
            loss = mlp_loss(params, xs[rows, it], ys[rows, it], ws[rows, it]).sum()
            grads = iter(torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            params = [{name: p - lr * next(grads) for name, p in layer.items()}
                      for layer in params]
    return params


def local_update(global_params, key, x, y, w, tau: int, lr, batch_size: int = 32,
                 idx=None):
    """One client: tau SGD steps on minibatches of its local data.
    x: (n, d), y: (n,), w: (n,) sample mask; ``idx`` (tau, batch_size)
    overrides the indices drawn from ``key`` (which may then be None).
    Returns updated params."""
    stacked = cohort_local_update(
        global_params, None if key is None else key.unsqueeze(0),
        x.unsqueeze(0), y.unsqueeze(0), w.unsqueeze(0),
        tau, lr, batch_size, None if idx is None else idx.unsqueeze(0))
    return [{name: p[0] for name, p in layer.items()} for layer in stacked]
