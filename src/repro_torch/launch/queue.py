"""Batched serving queue: wave-scheduled static batching, and continuous
batching with per-row cache positions.

The port of the JAX package's ``launch/queue.py``, with its scheduling,
admission order, metrics and timestamps (host clock, ``time.time``).

``WaveBatcher`` groups requests into WAVES of up to ``slots``: a wave
prefills together (prompts LEFT-padded with token 0 to the wave's longest,
so every request's last prompt token sits at position P - 1; the pad
tokens are attended, as in the reference), decodes in lockstep, and rows
whose request finished are ignored until the wave drains. A vlm's wave
gets zero image embeddings and an audio model's zero frames, as there.

``ContinuousBatcher`` gives every slot its own cache position
(``init_cache_fn(..., per_row=True)``): a finished slot admits the next
request at once, and one decode step both feeds prompts (a token at a
time) and generates. It serves the dense and vlm arch types, whose caches
are GQA caches; it feeds a vlm no image (decode embeds tokens only), as
the reference does.

Host reads per step are the reference's: a wave step reads its tokens; a
continuous step sends its tokens and positions to the device and reads
the next tokens back. Models run on the device their params lie on.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.launch.serve import image_offset
from repro_torch.models import pad_cache
from repro_torch.tree import tree_leaves

CONTINUOUS_ARCHS = ("dense", "vlm")


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (P,) int32
    max_new: int
    out: List[int] = field(default_factory=list)
    t_enqueue: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0

    @property
    def latency(self) -> float:
        return self.t_done - self.t_enqueue

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_enqueue


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


def _metrics(served: List[Request], wall: float) -> dict:
    total_tokens = sum(len(r.out) for r in served)
    return {
        "requests": len(served),
        "tokens": total_tokens,
        "wall_s": wall,
        "tok_per_s": total_tokens / max(wall, 1e-9),
        "mean_latency_s": float(np.mean([r.latency for r in served])),
        "mean_ttft_s": float(np.mean([r.ttft for r in served])),
    }


class WaveBatcher:
    def __init__(self, api, cfg, params, slots: int = 4, horizon: int = 128):
        self.api = api
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.horizon = horizon
        self.queue: List[Request] = []

    def submit(self, req: Request):
        req.t_enqueue = time.time()
        self.queue.append(req)

    def _make_wave(self) -> List[Request]:
        wave = self.queue[: self.slots]
        del self.queue[: len(wave)]
        return wave

    @torch.no_grad()
    def _run_wave(self, wave: List[Request]):
        cfg = self.cfg
        B = self.slots
        dev = _device(self.params)
        P = max(len(r.prompt) for r in wave)
        toks = np.zeros((B, P), np.int64)
        for i, r in enumerate(wave):
            toks[i, P - len(r.prompt):] = r.prompt      # left-pad
        tokens = torch.from_numpy(toks).to(dev)
        batch = {"tokens": tokens, "labels": tokens}
        if cfg.arch_type == "vlm":
            batch["img_embeds"] = torch.zeros(B, cfg.n_img_tokens, cfg.d_model, device=dev)
        if cfg.arch_type == "audio":
            batch["frames"] = torch.zeros(B, cfg.enc_frames, cfg.d_model, device=dev)
        off = image_offset(cfg, batch)
        logits, caches = self.api.prefill_fn(self.params, cfg, batch)
        caches = pad_cache(caches, P + off, P + off + self.horizon)
        now = time.time()
        for r in wave:
            r.t_first = now
        tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
        first = tok[:, 0].tolist()
        for i, r in enumerate(wave):
            r.out.append(first[i])
        done = [len(r.out) >= r.max_new for r in wave]
        step = 0
        while not all(done) and step < self.horizon - 1:
            logits, caches = self.api.decode_fn(self.params, cfg, tok, P + off + step, caches)
            tok = torch.argmax(logits[:, :, :cfg.vocab_size], dim=-1)
            nxt = tok[:, 0].tolist()
            now = time.time()
            for i, r in enumerate(wave):
                if not done[i]:
                    r.out.append(nxt[i])
                    if len(r.out) >= r.max_new:
                        done[i] = True
                        r.t_done = now
            step += 1
        now = time.time()
        for r in wave:
            if not r.t_done:
                r.t_done = now

    def run(self) -> dict:
        """Drain the queue; returns aggregate serving metrics."""
        served: List[Request] = []
        t0 = time.time()
        while self.queue:
            wave = self._make_wave()
            self._run_wave(wave)
            served.extend(wave)
        return _metrics(served, time.time() - t0)


# ===================================================================
# Continuous batching (per-row cache positions; GQA/dense archs)
# ===================================================================

def _reset_rows(caches, rows):
    """Invalidate cache rows of newly admitted slots: every ``positions``
    leaf of two or more axes (the stacked (n_layers, B, W) per-row
    positions) is set to -1 at ``rows`` of its second axis, in place.
    Returns ``caches``."""
    for name, leaf in caches.items():
        if isinstance(leaf, dict):
            _reset_rows(leaf, rows)
        elif name == "positions" and leaf.ndim >= 2:
            leaf[:, torch.as_tensor(rows, device=leaf.device)] = -1
    return caches


class ContinuousBatcher:
    """Per-slot positions: finished slots admit the next request
    IMMEDIATELY (no wave barrier). One decode step does both
    prompt-feeding and generation, so the batch is always full.

    Requires a per-row cache (``models/attention.py`` per_row=True): the
    dense and vlm arch types; MLA, SSM and other caches keep the wave
    scheduler. Raises ``ValueError`` for any other arch type.
    """

    def __init__(self, api, cfg, params, slots: int = 4, horizon: int = 128):
        if cfg.arch_type not in CONTINUOUS_ARCHS:
            raise ValueError("per-row decode supports GQA caches (see WaveBatcher otherwise): "
                             f"arch_type {cfg.arch_type!r} is not one of {CONTINUOUS_ARCHS}")
        self.api = api
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.horizon = horizon
        self.device = _device(params)
        self.caches = api.init_cache_fn(params, cfg, slots, horizon, torch.float32, per_row=True)
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * slots
        self.pos = np.zeros(slots, np.int64)
        self.fed = np.zeros(slots, np.int64)

    def submit(self, req: Request):
        req.t_enqueue = time.time()
        self.queue.append(req)

    def _admit(self):
        newly = []
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                self.active[s] = self.queue.pop(0)
                self.pos[s] = 0
                self.fed[s] = 0
                newly.append(s)
        if newly:
            self.caches = _reset_rows(self.caches, newly)

    def _token_for(self, s) -> int:
        req = self.active[s]
        if req is None:
            return 0
        if self.fed[s] < len(req.prompt):
            return int(req.prompt[self.fed[s]])
        return req.out[-1]

    @torch.no_grad()
    def step(self) -> bool:
        self._admit()
        if all(r is None for r in self.active):
            return False
        toks = torch.tensor([[self._token_for(s)] for s in range(self.slots)],
                            dtype=torch.int64).to(self.device)
        posv = torch.from_numpy(self.pos.astype(np.int32)).to(self.device)
        logits, self.caches = self.api.decode_fn(self.params, self.cfg, toks, posv, self.caches)
        nxt = torch.argmax(logits[:, 0, :self.cfg.vocab_size], dim=-1).cpu().numpy()
        now = time.time()
        for s in range(self.slots):
            req = self.active[s]
            if req is None:
                continue
            self.pos[s] += 1
            if self.fed[s] < len(req.prompt):
                self.fed[s] += 1
                if self.fed[s] == len(req.prompt):
                    req.t_first = now
                    req.out.append(int(nxt[s]))
            else:
                req.out.append(int(nxt[s]))
            if len(req.out) >= req.max_new or self.pos[s] >= self.horizon:
                req.t_done = now
                self.active[s] = None
        return True

    def run(self) -> dict:
        t0 = time.time()
        served = list(self.queue)
        while self.step():
            pass
        return _metrics(served, time.time() - t0)
