#!/usr/bin/env python3
"""Where the port's LM forward spends its time, on one NVIDIA GPU.

    python3 profile_lm.py [--arch smollm-135m|zamba2-7b]

Runs the LM configurations of ``chip_smoke.py`` for one arch, at full
width from PRNGKey(0): serving (batch 8, prompt 128, 32 greedy tokens
through ``repro_torch.launch.serve.generate``) and the forward loss with
``use_pallas=True``: smollm-135m (the default) at B=4, S=2048; zamba2-7b
at full depth, serving with ``use_pallas`` too (chunk 64), its loss at
B=1, S=2048. Each runs once to warm up and once under ``torch.profiler``
with CPU and CUDA activities. Prints, for each: the wall time, the
device's busy time (kernel and copy time on the card) and idle share
(1 - busy / wall), device time by kernel family (``flash_attention``,
``gated_rmsnorm``, ``ssd_scan``, ``rmsnorm``, matmuls, the rest) and the
kernels with the most device time; for serving also the host time and
device events per decode step. Exits non-zero without CUDA.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# first match wins: gated_rmsnorm_rows before rmsnorm_rows, the port's
# kernels before the matmul keys; "ssd_" covers every launch of the scan
# (ssd_chunk_scores, ssd_chunk_state, ssd_state_pass, ssd_chunk_out,
# ssd_scan_seq)
FAMILIES = (("flash_attention", ("flash_fwd",)), ("gated_rmsnorm", ("gated_rmsnorm_rows",)),
            ("ssd_scan", ("ssd_",)), ("rmsnorm", ("rmsnorm_rows",)),
            ("matmul", ("gemm", "cutlass", "xmma", "splitk")))


def family(name: str) -> str:
    low = name.lower()
    return next((fam for fam, keys in FAMILIES if any(k in low for k in keys)), "other")


def profiled(label: str, fn) -> dict:
    """Run ``fn`` under the profiler; print and return its device summary."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_family = {}
    for e in kernels:
        fam = family(e.key)
        by_family[fam] = by_family.get(fam, 0.0) + e.self_device_time_total / 1e3
    events = sum(e.count for e in kernels)
    print(f"{label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms in {events} device "
          f"events: idle share {1 - busy_ms / wall_ms:.4f}")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:16s} {ms:9.3f} ms device ({ms / busy_ms:6.1%} of busy)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "device_events": events, "by_family_ms": by_family}


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from chip_smoke import (HYBRID_ARCH, HYBRID_LOSS_B, HYBRID_LOSS_S, LM_ARCH, LOSS_B, LOSS_S,
                            SERVE_BATCH, SERVE_GEN, SERVE_PROMPT, card_line)

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=[LM_ARCH, HYBRID_ARCH], default=LM_ARCH)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_lm: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, serve_config
    from repro_torch.models import get_api

    print(f"card: {card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = args.arch
    hybrid = arch == HYBRID_ARCH
    loss_b, loss_s = (HYBRID_LOSS_B, HYBRID_LOSS_S) if hybrid else (LOSS_B, LOSS_S)
    cfg = get_config(arch)
    serve_cfg = serve_config(cfg.replace(use_pallas=True), SERVE_PROMPT) if hybrid else cfg
    dev = torch.device("cuda")
    params = get_api(cfg).init_params(prng.PRNGKey(0), cfg, device=dev)
    prompts = prng.randint(prng.PRNGKey(0, device=dev), (SERVE_BATCH, SERVE_PROMPT), 0,
                           cfg.vocab_size)
    generate(params, serve_cfg, prompts, 2)                     # warm-up
    out = {}

    def serve():
        out["gen"] = generate(params, serve_cfg, prompts, SERVE_GEN)

    rec = profiled(f"serve {arch} batch {SERVE_BATCH} prompt {SERVE_PROMPT} gen {SERVE_GEN}",
                   serve)
    steps = SERVE_GEN - 1
    rec.update(prefill_ms=out["gen"].prefill_s * 1e3,
               decode_ms_per_step=out["gen"].decode_s * 1e3 / steps)
    print(f"  prefill {rec['prefill_ms']:.2f} ms; decode {rec['decode_ms_per_step']:.3f} ms per "
          f"step (host clock, under the profiler)")
    pallas = cfg.replace(use_pallas=True)
    tokens = prng.randint(prng.PRNGKey(1, device=dev), (loss_b, loss_s), 0, cfg.vocab_size)
    batch = {"tokens": tokens, "labels": tokens}
    api = get_api(cfg)
    with torch.no_grad():
        api.loss_fn(params, pallas, batch)                      # warm-up
        loss = profiled(f"loss {arch} B={loss_b} S={loss_s} use_pallas",
                        lambda: api.loss_fn(params, pallas, batch))
    print(json.dumps({"serve": rec, "loss": loss}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
