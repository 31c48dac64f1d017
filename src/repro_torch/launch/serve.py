"""Batched serving: prefill + greedy decode loop for any ported LM.

A batch of prompts is prefilled (building per-layer caches), the caches are
grown to the serving horizon, then tokens are decoded step by step with
greedy sampling, as the JAX package's ``launch/serve.py`` does. The model is
drawn from ``--seed`` through ``repro_torch.prng`` (the JAX package's model
for the same seed) and the prompts from the same key, as there; for an
audio model (whisper) also the stub frame embeddings, ``0.02 * normal``
(B, enc_frames, d_model) from that key, and for a vlm (phi-3-vision)
image embeddings of zeros (B, n_img_tokens, d_model) ahead of the prompt,
whose positions shift the caches and the decode positions by
``n_img_tokens``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --preset tiny --device cpu

``--device`` defaults to CUDA, and raises without a card.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import torch

from repro_torch import prng
from repro_torch.configs import get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import get_api, pad_cache


@dataclass
class Generation:
    """Greedy tokens (B, gen) and the wall time of the prefill (forward,
    cache growth and the first token) and of the gen - 1 decode steps."""

    tokens: torch.Tensor
    prefill_s: float
    decode_s: float


def serve_features(key, cfg, batch: int) -> dict:
    """The model inputs besides the prompts that ``main`` makes from its
    key: an audio model's stub frames ``0.02 * normal(key, (B, enc_frames,
    d_model))`` and a vlm's image embeddings, zeros (B, n_img_tokens,
    d_model) in f32, as the JAX package's serve launcher makes them; none
    for the other families."""
    if cfg.arch_type == "vlm":
        return {"img_embeds": torch.zeros(batch, cfg.n_img_tokens, cfg.d_model,
                                          device=key.device)}
    if cfg.arch_type != "audio":
        return {}
    return {"frames": prng.normal(key, (batch, cfg.enc_frames, cfg.d_model)).mul_(0.02)}


def image_offset(cfg, features) -> int:
    """Positions ahead of the prompt: ``cfg.n_img_tokens`` where
    ``features`` hold image embeddings (which ``embed_inputs`` then puts
    ahead of the text), else 0."""
    return cfg.n_img_tokens if cfg.n_img_tokens and "img_embeds" in (features or {}) else 0


def serve_config(cfg, prompt_len: int):
    """The config a serve run uses: the SSM chunk cut to half the prompt
    (at least 8), as the JAX package's serve driver cuts it."""
    return cfg.replace(ssm_chunk=min(cfg.ssm_chunk, max(8, prompt_len // 2)))


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@torch.no_grad()
def prefill(params, cfg, prompts: torch.Tensor, gen: int, features=None):
    """Prefill ``prompts`` (B, P), with ``features`` (the model inputs
    besides the tokens: whisper's ``frames``, a vlm's ``img_embeds``) where
    given, and grow the caches from P + off to P + off + ``gen`` slots (off
    = ``image_offset(cfg, features)``). Returns the first greedy token (B, 1)
    and the caches."""
    api = get_api(cfg)
    P, off = prompts.shape[1], image_offset(cfg, features)
    logits, caches = api.prefill_fn(params, cfg,
                                    {"tokens": prompts, "labels": prompts, **(features or {})})
    caches = pad_cache(caches, P + off, P + off + gen)
    return torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1), caches


@torch.no_grad()
def decode(params, cfg, tok: torch.Tensor, caches, start: int, steps: int) -> list:
    """``steps`` greedy decode steps from ``tok`` at position ``start``.
    Returns the tokens, (B, 1) each. No host synchronisation, so a caller
    may capture it in a CUDA graph."""
    api = get_api(cfg)
    out = []
    for step in range(steps):
        logits, caches = api.decode_fn(params, cfg, tok, start + step, caches)
        tok = torch.argmax(logits[:, -1:, :cfg.vocab_size], dim=-1)
        out.append(tok)
    return out


def generate(params, cfg, prompts: torch.Tensor, gen: int, features=None) -> Generation:
    """Prefill ``prompts`` (B, P) (with ``features``, as ``prefill`` takes
    them) and decode ``gen`` greedy tokens in all, the first at position
    P + ``image_offset(cfg, features)``, on the device the params and
    prompts lie on."""
    P = prompts.shape[1]
    t0 = _clock(prompts.device)
    tok, caches = prefill(params, cfg, prompts, gen, features)
    t1 = _clock(prompts.device)
    out = [tok] + decode(params, cfg, tok, caches, P + image_offset(cfg, features), gen - 1)
    t2 = _clock(prompts.device)
    return Generation(torch.cat(out, dim=1), t1 - t0, t2 - t1)


def main(argv=None) -> Generation:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--preset", choices=["tiny", "full"], default="tiny")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device; default CUDA")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.preset == "tiny" else get_config(args.arch)
    cfg = serve_config(cfg, args.prompt_len)
    dev = resolve_device(args.device)
    api = get_api(cfg)
    key = prng.PRNGKey(args.seed, device=dev)
    params = api.init_params(key, cfg, device=dev)
    B, P, G = args.batch, args.prompt_len, args.gen
    prompts = prng.randint(key, (B, P), 0, cfg.vocab_size)

    print(f"serving {cfg.name} on {dev}: batch={B} prompt={P} gen={G}")
    res = generate(params, cfg, prompts, G, serve_features(key, cfg, B))
    print(f"prefill: {res.prefill_s:.2f}s")
    print(f"decoded {G - 1} steps in {res.decode_s:.2f}s "
          f"({B * (G - 1) / max(res.decode_s, 1e-9):.1f} tok/s batch-aggregate)")
    print("sample generations (token ids):")
    for b in range(min(B, 2)):
        print(f"  req{b}: {res.tokens[b][:16].tolist()} ...")
    return res


if __name__ == "__main__":
    main()
