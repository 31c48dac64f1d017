#!/usr/bin/env python3
"""Device time of the port's attention and SSD kernels, kernel by kernel,
on one NVIDIA GPU, with the profiler's figures checked against a CUDA
graph and CUDA events.

    python3 profile_kernels.py [--reps 20]

Runs ``flash_attention`` at smollm-135m's and zamba2-7b's causal shapes
and ``ssd_scan`` at zamba2-7b's loss and serve-prefill shapes (the shapes
of ``chip_smoke.py`` phases 9 and 13), in f32 and bf16, ``reps`` times
each under ``torch.profiler`` (between traced calls it does not count,
``profile_calls``), and prints the mean device time per call of
every CUDA kernel they launch (the scan's two or four launches apart), with
``scaled_dot_product_attention`` beside flash.

``torch.profiler`` has lost kernels on the GPU machine, so every piece of
work is also measured outside it (``crosscheck``): its kernels are counted
and named from a CUDA graph of one call (``kernels.graph_kernels``), and
timed with CUDA events, as device time per call of the graph replayed and
as eager time per call. The profiler's total device time and launch count
are printed beside those, with the gap. Exits non-zero without CUDA, and
when the profiler's launch count of a kernel family the script names
(``flash_attention``, ``ssd_scan``, ``rmsnorm``, ``fedavg``) differs from
the graph's; each window's counted launches are also held against their
kernels by correlation id (``launch_trace``). ``rmsnorm`` at (8192, 576), (2048, 2048) and (2048, 4096) f32
and ``fedavg`` at K=8 and K=4, N=6922 f32 (phases 8 and 2) are profiled and
cross-checked the same way.

Last, the host time of the ``fedavg`` and ``rmsnorm`` wrappers, part by
part (``host_parts``): each step a wrapper call can take, alone, on the
host clock over 10,000 calls (``chip_smoke.host_ms``), beside the whole
wrapper call and the one PyTorch call that computes the same function.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# name substrings of the port's kernel families (first match wins:
# gated_rmsnorm_rows before rmsnorm_rows; "ssd_" covers every launch of the
# scan: the Hopper route's ssd_state_tma and ssd_out_tma, the mma.sync
# route's ssd_chunk_scores, ssd_chunk_state, ssd_state_pass, ssd_chunk_out
# and ssd_scan_seq); "rmsnorm_rows" covers rmsnorm_rows_reg and the two-pass
# rmsnorm_rows, "fedavg_" fedavg_vec16 and fedavg_scalar; "indexfunc" is
# index_add_ (the MoE combine), "softmax" the chunked attention's softmax
FAMILIES = (("flash_attention", ("flash_fwd",)), ("gated_rmsnorm", ("gated_rmsnorm_rows",)),
            ("ssd_scan", ("ssd_",)), ("rmsnorm", ("rmsnorm_rows",)), ("fedavg", ("fedavg_",)),
            ("index_add", ("indexfunc",)), ("softmax", ("softmax",)),
            ("matmul", ("gemm", "cutlass", "xmma", "splitk")))
HOST_CALLS = 10_000     # calls timed per part of a wrapper: 50 windows of 200,
HOST_ROUNDS = 5         # in 5 rounds over the parts
# calls a profiler window holds for the microsecond kernels (rmsnorm, fedavg):
# a window of 20 such calls lasts about 0.3 ms, and one came back with no
# kernel at all on an H100
SHORT_CALLS = 200
# the host range of a profiler window whose launches are counted, and the
# host seconds of the guard calls around it
MEASURED = "profile_calls.measured"
GUARD_S = 0.01


def family(name: str) -> str:
    low = name.lower()
    return next((fam for fam, keys in FAMILIES if any(k in low for k in keys)), "other")


def _is_copy(key: str) -> bool:
    """Profiler rows of memory copies and sets, which a CUDA graph holds as
    memcpy/memset nodes and not as kernel nodes."""
    return key.startswith(("Memcpy", "Memset"))


def _guard(fn) -> None:
    """Calls of ``fn``, each waited for, until ``GUARD_S`` of host time has
    passed (at least one)."""
    import torch

    t0 = time.perf_counter()
    while True:
        fn()
        torch.cuda.synchronize()
        if time.perf_counter() - t0 >= GUARD_S:
            return


def profile_calls(fn, calls: int) -> tuple:
    """``calls`` calls of ``fn`` inside the host range ``MEASURED`` of the
    one active step of a ``torch.profiler`` window (CPU and CUDA
    activity). The window opens with a warm-up step of one call that the
    profiler traces and discards (kernels launched just after tracing
    starts went missing: the first 9 launches of a one-call zamba2 loss
    window on an H100), and the active step puts ``_guard`` calls, traced
    but not counted, before and after the measured ones: kineto keeps a
    device activity only where its start and end, on CUPTI's clock mapped
    to the host's, fall inside the active step's host-clock window, and
    that mapping put kernels up to 51 us before their own launches on an
    H100, so kernels near an edge of the window could be dropped. Only the
    device work of launches made inside ``MEASURED`` is counted
    (``measured_device``). Returns the profiler and the wall ms per call
    (host clock, around work that ends in a synchronise)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        _guard(fn)
        t0 = time.perf_counter()
        with record_function(MEASURED):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
        _guard(fn)
        prof.step()
    return prof, wall_ms


def _is_api(e) -> bool:
    """A CUDA API call, of the runtime or of libcuda (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...): a host-side kineto event."""
    from torch.autograd import DeviceType

    name = e.name()
    return e.device_type() == DeviceType.CPU and (
        name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper()))


def _window(prof) -> tuple:
    """The window's kineto events, and those of its CUDA API calls made
    inside the ``MEASURED`` range, by host clock."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
              if e.name() == MEASURED and e.device_type() == DeviceType.CPU]
    if len(ranges) != 1:
        raise RuntimeError(f"profile window holds {len(ranges)} {MEASURED!r} ranges, not 1")
    t0, t1 = ranges[0]
    return events, [e for e in events if _is_api(e) and t0 <= e.start_ns() <= t1]


def _device_work(events) -> list:
    """The device's kernels, copies and sets, without the annotations a
    scheduled window with CPU activity also records on the device timeline
    (``ProfilerStep*``, ``MEASURED``)."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type() == DeviceType.CUDA
            and e.name() != MEASURED and not e.name().startswith("ProfilerStep")]


def measured_device(prof) -> dict:
    """{kernel or copy: (device us, count)} of the device work launched
    inside the window's ``MEASURED`` range (each activity tied to its
    launch by CUPTI's correlation id)."""
    events, api = _window(prof)
    corr = {e.correlation_id() for e in api}
    rows = {}
    for e in _device_work(events):
        if e.correlation_id() in corr:
            us, n = rows.get(e.name(), (0.0, 0))
            rows[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    return rows


def launch_trace(prof, names=()) -> dict:
    """Hold the kernels of the window's measured launches (``cudaLaunchKernel``,
    ``cuLaunchKernel`` and their ``Ex`` forms, inside ``MEASURED``)
    against those launches, by the CUPTI correlation id each launch shares
    with the kernel it enqueues. A launch without its kernel is a kernel
    the profiler lost; for each, its index among the measured launches and
    its place in their host time (0 = the first launch, 1 = the last),
    and, where they are whole calls of the graph's ``names`` (one call's
    kernels in order), its family. Also the least time from a launch to
    its kernel's start as recorded (negative where CUPTI's clock, mapped
    to the host's, puts the kernel before its launch). Prints one line;
    returns the record."""
    events, api = _window(prof)
    launches = sorted((e.start_ns(), e.correlation_id()) for e in api
                      if "LaunchKernel" in e.name())
    starts = {e.correlation_id(): e.start_ns() for e in _device_work(events)
              if not _is_copy(e.name())}
    if not launches:
        print("  launch trace: the profiler recorded no measured launch")
        return {"launches": 0, "kernels": 0, "lost": []}
    t0, t1 = launches[0][0], launches[-1][0]
    whole = bool(names) and len(launches) % len(names) == 0
    lost = [{"index": i, "place": (t - t0) / max(t1 - t0, 1),
             "family": family(names[i % len(names)]) if whole else "?"}
            for i, (t, corr) in enumerate(launches) if corr not in starts]
    lead = [(starts[c] - t) / 1e3 for t, c in launches if c in starts]
    rec = {"launches": len(launches), "kernels": len(lead), "lost": lost,
           "min_launch_to_start_us": min(lead) if lead else None}
    line = (f"  launch trace: {len(launches)} measured launches, {len(lead)} of their kernels "
            f"recorded; least launch-to-start {rec['min_launch_to_start_us']} us")
    if lost:
        fams = {}
        for x in lost:
            fams[x["family"]] = fams.get(x["family"], 0) + 1
        runs = 1 + sum(b["index"] != a["index"] + 1 for a, b in zip(lost, lost[1:]))
        line += (f"; {len(lost)} lost in {runs} run(s) of consecutive launches, at launches "
                 f"{lost[0]['index']}-{lost[-1]['index']} ({lost[0]['place']:.4f}-"
                 f"{lost[-1]['place']:.4f} of the measured launches): "
                 + ", ".join(f"{f} {n}" for f, n in sorted(fams.items())))
    print(line)
    return rec


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


def crosscheck(label: str, fn, reps: int, profiler: dict, named=(), names=None) -> dict:
    """Hold the profiler's figures for one piece of work (``profiler``:
    {kernel or copy: (ms per call, launches per call)}) against a CUDA
    graph of one call and CUDA-event timings of the same work; print both
    with the gap. Launches count kernels only (a graph holds copies as
    other nodes); times include copies. Returns the record;
    ``record["mismatch"]`` lists the families of ``named`` whose launch
    counts differ (compared as totals where libcuda names no kernel)."""
    from repro_torch.kernels import graph_kernels

    names = graph_kernels(fn) if names is None else names
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


def host_parts(kind: str, shape: tuple) -> dict:
    """{part: fn} of one ``kind`` ("fedavg" or "rmsnorm") call at ``shape``
    (f32 on the current card): each step the wrapper takes, or took before
    the shared launch path (the ``Stream`` object, the no-op conversions,
    ``promote_types``), alone: the checks, the conversions, the
    allocation, the stream and device reads, the bound C entry point's
    call, which enqueues the kernel, and the count; then the whole wrapper
    call and the one PyTorch call that computes the same function. A part
    whose accessor this PyTorch lacks is left out."""
    import ctypes
    import functools

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import LAUNCHES, fedavg, rmsnorm
    from repro_torch.kernels.build import load

    dev = torch.device("cuda", torch.cuda.current_device())
    f32 = torch.float32
    lib = load(kind).lib
    entry = getattr(lib, f"{kind}_launch")
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kind == "fedavg":
        K, N = shape
        x, w = torch.randn(K, N, device=dev), torch.rand(K, device=dev)
        out = torch.empty(N, device=dev)
        entry.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int,
                                                                            ctypes.c_void_p]
        codes = {(f32, f32): (0, f32)}
        parts = {
            "checks (ndim, shape, float, device, contiguity)": lambda: (
                x.ndim != 2 or w.ndim != 1 or w.shape[0] != x.shape[0]
                or not (x.is_floating_point() and w.is_floating_point())
                or x.device != w.device or not x.is_contiguous()),
            "torch.promote_types": lambda: torch.promote_types(x.dtype, w.dtype),
            "dtype codes, one dict lookup": lambda: codes.get((x.dtype, w.dtype)),
            "w.to(f32).to(f32).contiguous(), no-op": lambda: w.to(f32).to(f32).contiguous(),
            "w dtype and contiguity tests": lambda: w.dtype == f32 and w.is_contiguous(),
            "torch.empty(N)": lambda: torch.empty(N, dtype=x.dtype, device=dev),
            "x.new_empty(N)": lambda: x.new_empty(N),
            "ctypes call, launch": lambda: entry(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                                 K, N, 0, stream),
            "wrapper fedavg(x, w)": lambda: fedavg(x, w),
            "library w @ x": lambda: w @ x,
        }
    else:
        rows, d = shape
        x, w = torch.randn(rows, d, device=dev), torch.rand(d, device=dev)
        out = torch.empty_like(x)
        entry.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                  ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        parts = {
            "checks (shape, float, device)": lambda: (
                x.ndim < 1 or w.shape != (x.shape[-1],)
                or not (x.is_floating_point() and w.is_floating_point()) or x.device != w.device),
            "autograd test": lambda: torch.is_grad_enabled() and (x.requires_grad
                                                                  or w.requires_grad),
            "x.reshape(-1, d).contiguous(), no-op": lambda: x.reshape(-1, d).contiguous(),
            "x.is_contiguous()": lambda: x.is_contiguous(),
            "torch.empty_like(x)": lambda: torch.empty_like(x),
            "w.to(f32).contiguous(), no-op": lambda: w.to(f32).contiguous(),
            "w dtype and contiguity tests": lambda: w.dtype == f32 and w.is_contiguous(),
            "out.view(x.shape)": lambda: out.view(x.shape),
            "ctypes call, launch": lambda: entry(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                                 rows, d, 1e-6, 0, stream),
            "wrapper rmsnorm(x, w)": lambda: rmsnorm(x, w),
            "library F.rms_norm": lambda: F.rms_norm(x, (d,), w, 1e-6),
        }
    cached = functools.lru_cache(maxsize=None)(lambda: lib)

    def count():
        LAUNCHES["host_probe"] += 1

    common = {
        "x.device.type": lambda: x.device.type,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch.cuda.current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "functools.lru_cache lookup": cached,
        "3 x data_ptr()": lambda: (x.data_ptr(), w.data_ptr(), out.data_ptr()),
        "LAUNCHES[name] += 1": count,
    }
    for name in ("_cuda_getDevice", "_cuda_getCurrentRawStream"):
        if hasattr(torch._C, name):
            fn = getattr(torch._C, name)
            common[f"torch._C.{name}"] = functools.partial(fn, dev.index) if "Stream" in name \
                else fn
    return {**common, **parts}


def host_profile() -> dict:
    """Print and return the host ms per call of every part of the fedavg
    and rmsnorm wrappers (``host_parts``) at the main paths' shapes: the
    median over ``HOST_ROUNDS`` rounds that each time every part in turn,
    so that a host that slows down during the profile weighs on all parts
    alike."""
    from chip_smoke import host_ms

    rec = {}
    reps = HOST_CALLS // 200 // HOST_ROUNDS
    for kind, shape in (("fedavg", (8, 6922)), ("fedavg", (4, 6922)), ("rmsnorm", (8192, 576))):
        label = f"{kind} {shape} f32"
        print(f"host time per call, {label} ({HOST_CALLS} calls a part):")
        parts = host_parts(kind, shape)
        times = {part: [] for part in parts}
        for _ in range(HOST_ROUNDS):
            for part, fn in parts.items():
                times[part].append(host_ms(fn, inner=200, reps=reps))
        rec[label] = {part: statistics.median(t) for part, t in times.items()}
        for part, ms in rec[label].items():
            print(f"    {ms * 1e3:8.3f} us  {part}")
    return rec


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as F

    from chip_smoke import (FLASH_SHAPES, FLASH_ZAMBA, FUSED_TIMED, NORM_FAMILIES, NORM_TIMED,
                            SSD_LOSS, SSD_SERVE, TIMED_MAIN, _ssd_inputs, card_line)

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_kernels: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import fedavg, flash_attention, graph_kernels, rmsnorm, ssd_scan

    print(f"card: {card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    failed = []

    def run(label, fn, named, calls=args.reps):
        prof, _ = profile_calls(fn, calls)
        times = {k: (us / 1e3 / calls, n / calls) for k, (us, n) in measured_device(prof).items()}
        show(label, times)
        names = graph_kernels(fn)
        launch_trace(prof, names)
        rec = crosscheck(label, fn, calls, times, named, names=names)
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
    for rows, d in (NORM_TIMED, *NORM_FAMILIES):
        x = torch.randn(rows, d, generator=gen, device=dev)
        w = torch.randn(d, generator=gen, device=dev)
        run(f"rmsnorm {(rows, d)} float32", lambda: rmsnorm(x, w), ("rmsnorm",), SHORT_CALLS)
        run(f"F.rms_norm {(rows, d)} float32", lambda: F.rms_norm(x, (d,), w, 1e-6), (),
            SHORT_CALLS)
    for K, N in (TIMED_MAIN, FUSED_TIMED):
        x = torch.randn(K, N, generator=gen, device=dev)
        w = torch.rand(K, generator=gen, device=dev)
        run(f"fedavg K={K} N={N} float32", lambda: fedavg(x, w), ("fedavg",), SHORT_CALLS)
        run(f"w @ x K={K} N={N} float32", lambda: w @ x, (), SHORT_CALLS)
    host_profile()
    if failed:
        print("profile_kernels FAILED: the profiler's launch counts differ from the CUDA "
              "graph's for " + "; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
