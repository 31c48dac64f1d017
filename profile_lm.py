#!/usr/bin/env python3
"""Where the port's LM forward spends its time, on one NVIDIA GPU.

    python3 profile_lm.py [--arch smollm-135m|zamba2-7b|qwen2-moe-a2.7b|xlstm-1.3b|
                           deepseek-v2-lite-16b|phi-3-vision-4.2b] [--train]

Runs the LM configurations of ``chip_smoke.py`` for one arch, at full
width from PRNGKey(0): serving (batch 8, prompt 128, 32 greedy tokens
through ``repro_torch.launch.serve.generate``) and the forward loss with
``use_pallas=True``: smollm-135m (the default) at B=4, S=2048; zamba2-7b
at full depth, serving with ``use_pallas`` too (chunk 64), its loss at
B=1, S=2048; qwen2-moe-a2.7b, xlstm-1.3b and deepseek-v2-lite-16b at full
depth (xlstm serving at chunk 64), their losses at B=1, S=2048 (xlstm's at
chunk 256; for xlstm and deepseek ``use_pallas`` changes nothing: the JAX
package sends none of their work to a kernel but the norms);
phi-3-vision-4.2b at full depth, serving behind 256 zero image embeddings
and its loss at B=1, S=2048 (256 image embeddings, 0.02 * normal, and
1,792 text tokens; 32 flash_attention launches at hd 96). Each runs
once to warm up, then under ``torch.profiler`` with CPU and CUDA
activities (``profile_kernels.profile_calls``: serving
once and the loss ``LOSS_CALLS`` times, between traced calls that are
not counted; figures per call). Prints, for each: the wall time, the
device's busy time (kernel and copy time on the card) and idle share
(1 - busy / wall), device time by kernel family (``flash_attention``,
``gated_rmsnorm``, ``ssd_scan``, ``rmsnorm``, ``index_add_``, softmax,
matmuls, the rest) and the kernels with the most device time; for
serving also the prefill and decode times of a ``generate`` call
outside the profiler (host clock).

Each piece of work is then measured outside the profiler
(``profile_kernels.crosscheck``): its kernels counted and named from a
CUDA graph of one run, its device time from replays of that graph and
from eager runs between CUDA events, beside the profiler's totals and the
gap, and each window's counted launches are held against their kernels
by correlation id (``profile_kernels.launch_trace``: lost kernels by
family and place, and the least launch-to-start time as recorded). Exits
non-zero without CUDA, and when the profiler's launch count of one of the
port's kernel families differs from the graph's.

With ``--train`` it breaks down one training step instead: the fused
AdamW server step of the ``arch`` family (``launch.train.arch_fused_step``:
forward and backward through ``torch.autograd``, the clipped AdamW update)
of smollm-135m at full width, B=8, S=256 (``TRAIN_B``, ``TRAIN_S``),
``TRAIN_CALLS`` steps under the profiler, each from the last one's params.
The step is held against a CUDA graph of it where capture works; where it
does not, the record says so and is marked unchecked.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from profile_kernels import (crosscheck, family, launch_trace, measured_device,  # noqa: E402
                             profile_calls)

PORT_FAMILIES = ("flash_attention", "gated_rmsnorm", "ssd_scan", "rmsnorm")
CHECK_REPS = 3          # graph replays and eager runs of each piece of work
LOSS_CALLS = 5          # loss calls in the profiler's measured step
TRAIN_B, TRAIN_S, TRAIN_CALLS = 8, 256, 3


def profiled(label: str, fn, calls: int) -> tuple:
    """Run ``fn`` ``calls`` times under the profiler; print and return its
    device summary per call, and the profiler."""
    prof, wall_ms = profile_calls(fn, calls)
    kernels = measured_device(prof)
    busy_ms = sum(us for us, _ in kernels.values()) / 1e3 / calls
    by_family = {}
    for key, (us, _) in kernels.items():
        fam = family(key)
        by_family[fam] = by_family.get(fam, 0.0) + us / 1e3 / calls
    events = sum(n for _, n in kernels.values()) / calls
    print(f"{label}: {calls} call(s) profiled; per call: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms in {events:g} device events: idle share {1 - busy_ms / wall_ms:.4f}")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:16s} {ms:9.3f} ms device ({ms / busy_ms:6.1%} of busy)")
    for key, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"    {us / 1e3 / calls:9.3f} ms  x{n / calls:<5g} {key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "device_events": events, "by_family_ms": by_family,
            "kernels": {key: (us / 1e3 / calls, n / calls)
                        for key, (us, n) in kernels.items()}}, prof


def checked(label: str, fn, failed: list, calls: int = 1) -> dict:
    """``profiled`` and then ``crosscheck`` of the same work, with the
    window's launches held against its kernels (``launch_trace``)."""
    from repro_torch.kernels import graph_kernels

    rec, prof = profiled(label, fn, calls)
    names = graph_kernels(fn)
    rec["trace"] = launch_trace(prof, names)
    rec["check"] = crosscheck(label, fn, CHECK_REPS, rec.pop("kernels"), PORT_FAMILIES,
                              names=names)
    failed.extend(f"{label}: {f}" for f in rec["check"]["mismatch"])
    return rec


def profile_train(arch: str, failed: list) -> dict:
    """One fused AdamW step of ``arch`` at full width, profiled and held
    against a CUDA graph of it where capture works."""
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.launch.train import arch_fused_step, server_opt
    from repro_torch.models import get_api

    cfg = get_config(arch)
    api = get_api(cfg)
    dev = torch.device("cuda")
    state = [api.init_params(prng.PRNGKey(0), cfg, device=dev)]
    state.append(server_opt().init(state[0]))
    tokens = prng.randint(prng.PRNGKey(1, device=dev), (TRAIN_B, TRAIN_S), 0, cfg.vocab_size)
    batch = {"tokens": tokens, "labels": tokens,
             "client_weights": torch.full((TRAIN_B,), 1.0 / TRAIN_B, device=dev)}
    step, _ = arch_fused_step(api, cfg)

    def train():
        _, state[0], state[1] = step(state[0], state[1], batch)

    train()                                                     # warm-up
    label = f"train {arch} arch_fused_step B={TRAIN_B} S={TRAIN_S}"
    rec, prof = profiled(label, train, TRAIN_CALLS)
    rec["trace"] = launch_trace(prof)
    kernels = rec.pop("kernels")
    try:
        rec["check"] = crosscheck(label, train, CHECK_REPS, kernels, PORT_FAMILIES)
    except RuntimeError as e:          # the step could not be captured
        rec["check"] = {"unchecked": f"{type(e).__name__}: {e}"}
        print(f"  cross-check {label}: UNCHECKED, no CUDA graph of the step ({e})")
    failed.extend(f"{label}: {f}" for f in rec["check"].get("mismatch", []))
    return rec


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from chip_smoke import (HYBRID_ARCH, HYBRID_LOSS_B, HYBRID_LOSS_S, LM_ARCH, LOSS_B, LOSS_S,
                            MLA_ARCH, MLA_LOSS_B, MLA_LOSS_S, MOE_ARCH, MOE_LOSS_B, MOE_LOSS_S,
                            SERVE_BATCH, SERVE_GEN, SERVE_PROMPT, VLM_ARCH, VLM_LOSS_B,
                            VLM_LOSS_S, XLSTM_ARCH, XLSTM_LOSS_B, XLSTM_LOSS_S, card_line)

    loss_shapes = {LM_ARCH: (LOSS_B, LOSS_S), HYBRID_ARCH: (HYBRID_LOSS_B, HYBRID_LOSS_S),
                   MOE_ARCH: (MOE_LOSS_B, MOE_LOSS_S), XLSTM_ARCH: (XLSTM_LOSS_B, XLSTM_LOSS_S),
                   MLA_ARCH: (MLA_LOSS_B, MLA_LOSS_S), VLM_ARCH: (VLM_LOSS_B, VLM_LOSS_S)}
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(loss_shapes), default=LM_ARCH)
    ap.add_argument("--train", action="store_true",
                    help="break down one fused AdamW training step of smollm-135m instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_lm: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if args.train:
        print(f"card: {card_line()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        failed = []
        print(json.dumps({"train": profile_train(LM_ARCH, failed)}))
        if failed:
            print("profile_lm FAILED: the profiler's launch counts differ from the CUDA "
                  "graph's for " + "; ".join(failed), file=sys.stderr)
            return 1
        return 0
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (decode, generate, image_offset, prefill, serve_config,
                                          serve_features)
    from repro_torch.models import get_api

    print(f"card: {card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = args.arch
    loss_b, loss_s = loss_shapes[arch]
    cfg = get_config(arch)
    # zamba2 serves under use_pallas, as chip_smoke.py phase 14 does; every
    # arch with launch/serve.py's SSM chunk rule
    serve_cfg = serve_config(cfg.replace(use_pallas=arch == HYBRID_ARCH), SERVE_PROMPT)
    dev = torch.device("cuda")
    api = get_api(cfg)
    params = api.init_params(prng.PRNGKey(0), cfg, device=dev)
    prompts = prng.randint(prng.PRNGKey(0, device=dev), (SERVE_BATCH, SERVE_PROMPT), 0,
                           cfg.vocab_size)
    # a vlm's zero image embeddings, as the serve launcher makes them
    features = serve_features(prng.PRNGKey(0, device=dev), cfg, SERVE_BATCH)
    off = image_offset(cfg, features)
    failed = []

    def serve():
        """``generate``'s work without its host clocks (which synchronise)."""
        tok, caches = prefill(params, serve_cfg, prompts, SERVE_GEN, features)
        decode(params, serve_cfg, tok, caches, SERVE_PROMPT + off, SERVE_GEN - 1)

    generate(params, serve_cfg, prompts, 2, features)           # warm-up
    gen = generate(params, serve_cfg, prompts, SERVE_GEN, features)  # host timings
    steps = SERVE_GEN - 1
    rec = checked(f"serve {arch} batch {SERVE_BATCH} prompt {SERVE_PROMPT} gen {SERVE_GEN}",
                  serve, failed)
    rec.update(prefill_ms=gen.prefill_s * 1e3, decode_ms_per_step=gen.decode_s * 1e3 / steps)
    print(f"  generate outside the profiler: prefill {rec['prefill_ms']:.2f} ms; decode "
          f"{rec['decode_ms_per_step']:.3f} ms per step (host clock)")
    pallas = cfg.replace(use_pallas=True)
    # a vlm's loss_s counts its image slots: 0.02 * normal embeddings, then text
    tokens = prng.randint(prng.PRNGKey(1, device=dev), (loss_b, loss_s - off), 0,
                          cfg.vocab_size)
    batch = {"tokens": tokens, "labels": tokens}
    if off:
        batch["img_embeds"] = prng.normal(prng.PRNGKey(1, device=dev),
                                          (loss_b, off, cfg.d_model)).mul_(0.02)
    with torch.no_grad():
        api.loss_fn(params, pallas, batch)                      # warm-up
        loss = checked(f"loss {arch} B={loss_b} S={loss_s} use_pallas",
                       lambda: api.loss_fn(params, pallas, batch), failed, LOSS_CALLS)
    print(json.dumps({"serve": rec, "loss": loss}))
    if failed:
        print("profile_lm FAILED: the profiler's launch counts differ from the CUDA graph's "
              "for " + "; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
