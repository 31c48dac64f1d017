#!/usr/bin/env python3
"""Device time of the port's attention and SSD kernels, kernel by kernel,
on one NVIDIA GPU, with the profiler's figures checked against a CUDA
graph and CUDA events.

    python3 profile_kernels.py [--reps 20]

Runs ``flash_attention`` at smollm-135m's and zamba2-7b's causal shapes
and ``ssd_scan`` at zamba2-7b's loss and serve-prefill shapes (the shapes
of ``chip_smoke.py`` phases 9 and 13), in f32 and bf16, ``reps`` times
each under ``torch.profiler`` (after a warm-up call it traces and
discards, ``profile_calls``), and prints the mean device time per call of
every CUDA kernel they launch (the scan's two or four launches apart), with
``scaled_dot_product_attention`` beside flash.

``torch.profiler`` has lost kernels on the GPU machine, so every piece of
work is also measured outside it (``crosscheck``): its kernels are counted
and named from a CUDA graph of one call (``kernels.graph_kernels``), and
timed with CUDA events, as device time per call of the graph replayed and
as eager time per call. The profiler's total device time and launch count
are printed beside those, with the gap. Exits non-zero without CUDA, and
when the profiler's launch count of a kernel family the script names
(``flash_attention``, ``ssd_scan``) differs from the graph's.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# name substrings of the port's kernel families (first match wins:
# gated_rmsnorm_rows before rmsnorm_rows; "ssd_" covers every launch of the
# scan: ssd_chunk_scores, ssd_chunk_state, ssd_state_pass, ssd_chunk_out,
# ssd_scan_seq)
FAMILIES = (("flash_attention", ("flash_fwd",)), ("gated_rmsnorm", ("gated_rmsnorm_rows",)),
            ("ssd_scan", ("ssd_",)), ("rmsnorm", ("rmsnorm_rows",)),
            ("matmul", ("gemm", "cutlass", "xmma", "splitk")))


def family(name: str) -> str:
    low = name.lower()
    return next((fam for fam, keys in FAMILIES if any(k in low for k in keys)), "other")


def _is_copy(key: str) -> bool:
    """Profiler rows of memory copies and sets, which a CUDA graph holds as
    memcpy/memset nodes and not as kernel nodes."""
    return key.startswith(("Memcpy", "Memset"))


def profile_calls(fn, calls: int, cpu: bool = False) -> tuple:
    """``calls`` calls of ``fn`` in the one active step of a
    ``torch.profiler`` window (CUDA activity, and CPU with ``cpu``), after
    a warm-up step of one call that the profiler already traces and then
    discards: kernels launched just after tracing starts can go missing
    (the first 9 launches of a one-call zamba2 loss window on an H100), so
    no measured call is launched then. Returns the profiler and the wall
    ms per call (host clock, around work that ends in a synchronise)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
        prof.step()
    return prof, wall_ms


def device_events(prof) -> list:
    """The profiler's rows of device work, kernels and copies, without the
    step annotation (``ProfilerStep*``) that a scheduled window with CPU
    activity also records on the device timeline, spanning the step."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.key.startswith("ProfilerStep")]


def device_ms(fn, reps: int) -> dict:
    """{kernel: (mean device ms per call, launches per call)} of the CUDA
    kernels (and copies) ``fn`` launches, under the profiler."""
    prof, _ = profile_calls(fn, reps)
    return {e.key: (e.self_device_time_total / 1e3 / reps, e.count / reps)
            for e in device_events(prof)}


def graph_replay_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn`` captured once in a CUDA graph and
    replayed ``reps`` times between two CUDA events (after one warm-up
    replay): no host time between its kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def eager_ms(fn, reps: int) -> float:
    """Device-clock ms per call of ``reps`` eager calls between two CUDA
    events (host launch time included where it holds the card back)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def crosscheck(label: str, fn, reps: int, profiler: dict, named=()) -> dict:
    """Hold the profiler's figures for one piece of work (``profiler``:
    {kernel or copy: (ms per call, launches per call)}) against a CUDA
    graph of one call and CUDA-event timings of the same work; print both
    with the gap. Launches count kernels only (a graph holds copies as
    other nodes); times include copies. Returns the record;
    ``record["mismatch"]`` lists the families of ``named`` whose launch
    counts differ (compared as totals where libcuda names no kernel)."""
    from repro_torch.kernels import graph_kernels

    names = graph_kernels(fn)
    kernels = {k: v for k, v in profiler.items() if not _is_copy(k)}
    prof_ms = sum(ms for ms, _ in profiler.values())
    prof_n = sum(n for _, n in kernels.values())
    graph_ms = graph_replay_ms(fn, reps)
    eager = eager_ms(fn, reps)
    by_family = {}
    for fam in sorted({family(k) for k in kernels} | {family(k) for k in names}):
        by_family[fam] = {"profiler": sum(n for k, (_, n) in kernels.items() if family(k) == fam),
                          "graph": sum(family(k) == fam for k in names)}
    unnamed = sum(k == "?" for k in names)
    if unnamed:
        mismatch = [f for f in named if abs(prof_n - len(names)) > 1e-9]
    else:
        mismatch = [f for f in named if abs(by_family.get(f, {}).get("profiler", 0)
                                            - by_family.get(f, {}).get("graph", 0)) > 1e-9]
    gap = prof_ms / graph_ms - 1 if graph_ms else float("nan")
    print(f"  cross-check {label}: profiler {prof_ms:.4f} ms device in {prof_n:g} kernel "
          f"launches per call; CUDA graph {len(names)} kernels per call, replayed "
          f"{graph_ms:.4f} ms per call (gap profiler - graph {prof_ms - graph_ms:+.4f} ms, "
          f"{gap:+.1%}); eager {eager:.4f} ms per call (CUDA events)")
    print("    launches per call by family (profiler / graph): " + ", ".join(
        f"{f} {v['profiler']:g}/{v['graph']}" for f, v in by_family.items())
          + (f"; {unnamed} graph kernels libcuda could not name, so the named families "
             "are checked by the totals" if unnamed else ""))
    for f in mismatch:
        print(f"    MISMATCH in {f}: profiler {by_family.get(f, {}).get('profiler', 0):g}, "
              f"graph {by_family.get(f, {}).get('graph', 0)} launches per call "
              f"(totals {prof_n:g} / {len(names)})")
    return {"profiler_ms": prof_ms, "profiler_launches": prof_n, "graph_launches": len(names),
            "graph_ms": graph_ms, "eager_ms": eager, "by_family": by_family,
            "unnamed": unnamed, "mismatch": mismatch}


def show(label: str, times: dict) -> None:
    total = sum(ms for ms, _ in times.values())
    print(f"{label}: {total:.4f} ms device per call")
    for name, (ms, n) in sorted(times.items(), key=lambda kv: -kv[1][0]):
        print(f"    {ms:9.4f} ms  x{n:<4g} {name[:100]}")


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
    failed = []

    def run(label, fn, named):
        times = device_ms(fn, args.reps)
        show(label, times)
        rec = crosscheck(label, fn, args.reps, times, named)
        failed.extend(f"{label}: {f}" for f in rec["mismatch"])

    for B, H, KV, Sq, Sk, hd in (FLASH_SHAPES[0], FLASH_ZAMBA):
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, H, Sq, hd, generator=gen, device=dev).to(dtype)
            k, v = (torch.randn(B, KV, Sk, hd, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            where = f"{(B, H, KV, Sq, Sk, hd)} {str(dtype)[6:]}"
            run(f"flash_attention {where}", lambda: flash_attention(q, k, v, causal=True),
                ("flash_attention",))
            run(f"SDPA {where}", lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), ())
    for B, H, L, P, N, chunk in (SSD_LOSS, SSD_SERVE):
        x, a, b, c = _ssd_inputs(gen, B, H, L, P, N, dev, shared_bc=True)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            bd, cd = (t[:, :1].to(dtype).expand(B, H, L, N) for t in (b, c))
            run(f"ssd_scan {(B, H, L, P, N)} chunk {chunk} {str(dtype)[6:]}",
                lambda: ssd_scan(xd, a, bd, cd, chunk, return_state=True), ("ssd_scan",))
    if failed:
        print("profile_kernels FAILED: the profiler's launch counts differ from the CUDA "
              "graph's for " + "; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
