#!/usr/bin/env python3
"""Device time of the port's attention and SSD kernels, kernel by kernel,
on one NVIDIA GPU.

    python3 profile_kernels.py [--reps 20]

Runs ``flash_attention`` at smollm-135m's and zamba2-7b's causal shapes
and ``ssd_scan`` at zamba2-7b's loss and serve-prefill shapes (the shapes
of ``chip_smoke.py`` phases 9 and 13), in f32 and bf16, ``reps`` times
each under ``torch.profiler``, and prints the mean device time per call of
every CUDA kernel they launch (the scan's two or four launches apart), with
``scaled_dot_product_attention`` beside flash. Exits non-zero without
CUDA.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def device_ms(fn, reps: int) -> dict:
    """Mean device ms per call of each CUDA kernel ``fn`` launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def show(label: str, times: dict) -> None:
    total = sum(times.values())
    print(f"{label}: {total:.4f} ms device per call")
    for name, ms in sorted(times.items(), key=lambda kv: -kv[1]):
        print(f"    {ms:9.4f} ms  {name[:100]}")


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as F

    from chip_smoke import FLASH_SHAPES, FLASH_ZAMBA, SSD_LOSS, SSD_SERVE, _ssd_inputs, card_line

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_kernels: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention, ssd_scan

    print(f"card: {card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, H, KV, Sq, Sk, hd in (FLASH_SHAPES[0], FLASH_ZAMBA):
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, H, Sq, hd, generator=gen, device=dev).to(dtype)
            k, v = (torch.randn(B, KV, Sk, hd, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            where = f"{(B, H, KV, Sq, Sk, hd)} {str(dtype)[6:]}"
            show(f"flash_attention {where}",
                 device_ms(lambda: flash_attention(q, k, v, causal=True), args.reps))
            show(f"SDPA {where}", device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), args.reps))
    for B, H, L, P, N, chunk in (SSD_LOSS, SSD_SERVE):
        x, a, b, c = _ssd_inputs(gen, B, H, L, P, N, dev, shared_bc=True)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            bd, cd = (t[:, :1].to(dtype).expand(B, H, L, N) for t in (b, c))
            show(f"ssd_scan {(B, H, L, P, N)} chunk {chunk} {str(dtype)[6:]}",
                 device_ms(lambda: ssd_scan(xd, a, bd, cd, chunk, return_state=True),
                           args.reps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
