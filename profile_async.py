#!/usr/bin/env python3
"""Where the port's async flush spends its time, on one NVIDIA GPU.

    python3 profile_async.py [--aggregator fedadam|fedavg]

Runs the async configuration of ``chip_smoke.py`` phase 6 (3 synthetic
tasks, 40 clients, bimodal speeds, buffer 4, tau 3, 200 arrivals, vmap
backend) once to warm up and once under ``torch.profiler`` with CPU and
CUDA activities, and reads the port's own spans (``repro_torch/tracing.py``)
from the trace: ``mmfl.batch`` (keys and data for a cohort), ``mmfl.cohort``
(tau SGD steps), ``mmfl.fold`` (the fold, the fused kernel for a server
optimizer), ``mmfl.eval`` (test accuracy, read back to the host) and
``mmfl.allocate`` (assignment, arrival and cost draws). Prints the wall
time and flushes per second, the device's busy time (kernel and copy time
on the card) and idle share (1 - busy / wall), and each span's host time.
Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import copy
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SPANS = ("mmfl.batch", "mmfl.cohort", "mmfl.fold", "mmfl.eval", "mmfl.allocate")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--aggregator", default="fedadam", choices=("fedadam", "fedavg"))
    args = parser.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_async: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from chip_smoke import ARRIVALS, async_spec, card_line
    from repro_torch.api import run_scenario

    print(f"card: {card_line()}")
    spec = async_spec(None if args.aggregator == "fedavg" else args.aggregator)
    run_scenario(copy.deepcopy(spec))           # warm-up: CUDA context, cuBLAS, builds
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run_scenario(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    flushes = len(res.time)
    events = prof.key_averages()
    # the program's spans also appear as device-side ranges; only kernels
    # and copies count as busy time
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and not e.key.startswith("mmfl.")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"async {args.aggregator}: {flushes} flushes of {ARRIVALS} arrivals in "
          f"{wall * 1e3:.1f} ms wall ({flushes / wall:.2f} flushes/s, "
          f"{wall * 1e3 / flushes:.3f} ms per flush)")
    print(f"device busy {busy_ms:.3f} ms of {wall * 1e3:.1f} ms wall in "
          f"{sum(e.count for e in kernels)} device events: idle share "
          f"{1 - busy_ms / (wall * 1e3):.4f}")
    print("spans (host time, whole run; nested spans count inside their parents):")
    for e in sorted((e for e in events if e.key in SPANS and e.device_type == DeviceType.CPU),
                    key=lambda e: -e.cpu_time_total):
        print(f"  {e.key:16s} calls {e.count:5d}  host {e.cpu_time_total / 1e3:9.3f} ms "
              f"({e.cpu_time_total / 1e4 / wall:5.1f}% of wall)  device "
              f"{e.device_time_total / 1e3:8.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
