#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero, and the result lines are
printed only when every phase passed:

1. Card: the GPU's name and power limit, torch/CUDA versions, the nvcc
   build of every kernel from the sources in this checkout (sm_90a), and
   TF32 switched off for matmul and cuDNN.
2. Kernels against their plain versions on the card: fedavg at the main
   path's fold shapes and at an LM-scale fold, f32 and bf16, with times
   (CUDA events, median of 20; at the main path's small shapes also as
   device time inside a CUDA graph) beside the memory bound, the plain
   version and one PyTorch call that computes the same function.
3. The slice: ``repro_torch.api.run_scenario`` on the quickstart
   configuration (3 synthetic tasks, 40 clients, participation 0.2,
   tau=3, 25 rounds, alpha=3, vmap backend) on the card, with fedfair and
   random allocation. Every non-empty (round, task) fold must launch the
   fedavg kernel exactly once.
4. Card against CPU: the same fedfair and round_robin runs on the CPU.
5. A JSON line describing every kernel, the card line, and the final
   ``{"ok": true, "device": ...}`` line.

Needs CUDA, nvcc (``$CUDA_HOME/bin``, ``PATH`` or ``/usr/local/cuda``)
and nothing of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet: HBM3 bandwidth and f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

MAIN_K = (1, 3, 8, 16)
MAIN_N = (1738, 3786, 6922, 2049)   # synth-mnist, -fmnist, -cifar MLPs; a ragged N
TIMED_MAIN = (8, 6922)              # the largest fold the slice makes
LM_K, LM_N = 8, 2**27               # about smollm-135m's parameter count
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
TASKS = ("synth-mnist", "synth-cifar", "synth-fmnist")
ROUNDS = 25


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def time_ms(fn, inner: int = 1, reps: int = 20) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` back-to-back
    calls, per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn, inner: int = 200, reps: int = 20) -> float:
    """Device time per call: ``inner`` calls captured once in a CUDA graph,
    the graph replayed and timed as in ``time_ms``. Unlike back-to-back
    eager calls this leaves out the host's per-call overhead."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return time_ms(graph.replay, reps=reps) / inner


def fold_bound_ms(K: int, N: int, in_bytes: int, out_bytes: int) -> tuple:
    """Least time for the fold: x and w read once, out written once, at the
    data-sheet bandwidth; 2*K*N f32 flops at the f32 rate. The larger wins."""
    bytes_ms = (K * N * in_bytes + 4 * K + N * out_bytes) / PEAK_BYTES_PER_S * 1e3
    ops_ms = 2 * K * N / PEAK_F32_FLOP_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_card():
    import torch

    from repro_torch.kernels.build import load

    print("== phase 1: card")
    line = card_line()
    print(f"card: {line}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    built = load("fedavg")
    print(f"nvcc build fedavg: {built.seconds:.2f} s -> {built.path.name}")
    for ln in built.log.strip().splitlines():
        print(f"  {ln}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return line


def _fold_inputs(rng, K, N, dev):
    import numpy as np
    import torch

    x = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32)).to(dev)
    r = rng.standard_normal(K).astype(np.float64)
    w = np.exp(r - r.max())
    return x, torch.from_numpy((w / w.sum()).astype(np.float32)).to(dev)


def phase_kernels():
    import numpy as np
    import torch

    from repro_torch.kernels import fedavg
    from repro_torch.kernels.ref import ref_fedavg

    print("== phase 2: fedavg kernel vs plain version on the card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    errs = {"float32": 0.0, "bfloat16": 0.0}
    timed = None
    for K in MAIN_K:
        for N in MAIN_N:
            x32, w = _fold_inputs(rng, K, N, dev)
            for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                x = x32.to(dtype)
                got, want = fedavg(x, w), ref_fedavg(x, w)
                torch.cuda.synchronize()
                if got.dtype != dtype or got.shape != (N,):
                    fail(f"fedavg K={K} N={N} {name}: got {got.dtype} {tuple(got.shape)}")
                err = (got.float() - want.float()).abs().max().item()
                errs[name] = max(errs[name], err)
                if not err <= TOL[name]:
                    fail(f"fedavg K={K} N={N} {name}: max |err| {err} > {TOL[name]}")
            if (K, N) == TIMED_MAIN:
                bound, by = fold_bound_ms(K, N, 4, 4)
                fns = {"": lambda: fedavg(x32, w), "plain_": lambda: ref_fedavg(x32, w),
                       "library_": lambda: w @ x32}
                timed = {"bound_ms": bound, "bound_by": by}
                for key, fn in fns.items():
                    timed[f"{key}ms"] = graph_ms(fn)
                    timed[f"eager_{key}ms"] = time_ms(fn, inner=200)
    print(f"main-path shapes K in {MAIN_K} x N in {MAIN_N}: max |err| "
          f"f32 {errs['float32']:.3g} (tol {TOL['float32']}), "
          f"bf16 {errs['bfloat16']:.3g} (tol {TOL['bfloat16']})")
    print(f"main-path fold K={TIMED_MAIN[0]} N={TIMED_MAIN[1]} f32, device time (CUDA graph): "
          f"kernel {timed['ms']:.5f} ms, plain {timed['plain_ms']:.5f} ms, library (w @ x) "
          f"{timed['library_ms']:.5f} ms, bound {timed['bound_ms']:.6f} ms ({timed['bound_by']}); "
          f"eager per call: kernel {timed['eager_ms']:.5f} ms, plain {timed['eager_plain_ms']:.5f} "
          f"ms, library {timed['eager_library_ms']:.5f} ms")

    lm = {}
    t0 = time.perf_counter()
    x32 = torch.from_numpy(rng.random((LM_K, LM_N), dtype=np.float32)).to(dev).mul_(2).sub_(1)
    _, w = _fold_inputs(rng, LM_K, 1, dev)
    print(f"LM-scale inputs K={LM_K} N={LM_N}: {time.perf_counter() - t0:.1f} s to make")
    for name, dtype, size in (("float32", torch.float32, 4), ("bfloat16", torch.bfloat16, 2)):
        x = x32 if dtype == torch.float32 else x32.to(dtype)
        got, want = fedavg(x, w), ref_fedavg(x, w)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= TOL[name]:
            fail(f"fedavg LM-scale {name}: max |err| {err} > {TOL[name]}")
        errs[name] = max(errs[name], err)
        bound, by = fold_bound_ms(LM_K, LM_N, size, size)
        w_lib = w.to(dtype)
        rec = {
            "ms": time_ms(lambda: fedavg(x, w)),
            "plain_ms": time_ms(lambda: ref_fedavg(x, w)),
            "library_ms": time_ms(lambda: w_lib @ x),
            "bound_ms": bound, "bound_by": by, "max_abs_err": err,
        }
        lm[name] = rec
        del got, want
        print(f"LM-scale fold K={LM_K} N={LM_N} {name}: kernel {rec['ms']:.4f} ms "
              f"({rec['bound_ms'] / rec['ms']:.1%} of the {by} bound {rec['bound_ms']:.4f} ms), "
              f"plain {rec['plain_ms']:.4f} ms, library (w @ x) {rec['library_ms']:.4f} ms, "
              f"max |err| {err:.3g}")
    del x32
    torch.cuda.empty_cache()
    return errs, timed, lm


def quickstart_spec(strategy: str):
    from repro_torch.api import (AllocationSpec, ClientPopulationSpec, RuntimeSpec,
                                 ScenarioSpec, TaskSpec)

    return ScenarioSpec(
        name=f"quickstart-{strategy}",
        seed=0,
        tasks=[TaskSpec(t, options={"n_range": [100, 150]}) for t in TASKS],
        clients=ClientPopulationSpec(n_clients=40, participation=0.2),
        allocation=AllocationSpec(strategy=strategy, alpha=3.0),
        runtime=RuntimeSpec(backend="vmap", rounds=ROUNDS, tau=3))


def run_counted(strategy: str, device: str):
    """One run of the slice with the launch counts set to 0 just before
    it; returns the result and the counts read just after."""
    from repro_torch.api import run_scenario
    from repro_torch.kernels import LAUNCHES, reset_launches

    spec = quickstart_spec(strategy)
    reset_launches()
    res = run_scenario(spec, device=device)
    return res, dict(LAUNCHES)


def phase_slice():
    import numpy as np

    print("== phase 3: the sync slice on the card (run_scenario, vmap backend)")
    runs = {}
    for strategy in ("fedfair", "random"):
        res, launches = run_counted(strategy, "cuda")
        folds = int((res.alloc_counts > 0).sum())
        if launches.get("fedavg", 0) != folds:
            fail(f"{strategy}: fedavg launched {launches.get('fedavg', 0)} times for "
                 f"{folds} non-empty (round, task) folds")
        devices = {leaf.device.type for p in res.params for layer in p for leaf in layer.values()}
        if devices != {"cuda"}:
            fail(f"{strategy}: final params on {devices}")
        if res.acc.shape != (ROUNDS, len(TASKS)) or not np.isfinite(res.acc).all():
            fail(f"{strategy}: accuracy curve {res.acc.shape} not finite")
        runs[strategy] = (res, launches)
        print(f"{strategy}: {ROUNDS / res.wall_time:.2f} rounds/s ({res.wall_time:.3f} s), "
              f"fedavg launches {launches['fedavg']} = non-empty folds {folds} "
              f"({launches['fedavg'] / ROUNDS:.2f} per round), final acc "
              + " ".join(f"{n}={a:.4f}" for n, a in zip(res.task_names, res.acc[-1]))
              + f", min-acc {res.fairness['min_acc']:.4f}")
    return runs


def phase_card_vs_cpu(gpu_fedfair):
    import numpy as np

    print("== phase 4: card vs CPU")
    cpu, _ = run_counted("fedfair", "cpu")
    diff = np.abs(cpu.acc - gpu_fedfair.acc).max()
    differ = np.nonzero((cpu.alloc != gpu_fedfair.alloc).any(axis=1))[0]
    print(f"fedfair on the CPU: {ROUNDS / cpu.wall_time:.2f} rounds/s ({cpu.wall_time:.3f} s)")
    print(f"fedfair: max |acc card - acc cpu| {diff:.6f}; allocation traces "
          + (f"first differ at round {int(differ[0])}" if len(differ) else "identical"))
    if not diff <= 0.01:
        fail(f"fedfair card vs CPU accuracy differs by {diff}")
    rr_gpu, _ = run_counted("round_robin", "cuda")
    rr_cpu, _ = run_counted("round_robin", "cpu")
    rr_diff = np.abs(rr_cpu.acc - rr_gpu.acc).max()
    same = bool((rr_cpu.alloc == rr_gpu.alloc).all())
    print(f"round_robin: allocation traces identical={same}, "
          f"max |acc card - acc cpu| {rr_diff:.6f}")
    if not same or not rr_diff <= 0.01:
        fail("round_robin card vs CPU disagree")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    line = phase_card()
    errs, timed, lm = phase_kernels()
    runs = phase_slice()
    phase_card_vs_cpu(runs["fedfair"][0])
    kernel = {
        "name": "fedavg",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedavg.cu",
        "replaces": "src/repro/kernels/fedavg.py:43",
        "launches": runs["fedfair"][1]["fedavg"],
        "max_abs_err": errs["float32"],
        "max_abs_err_bf16": errs["bfloat16"],
        "shape": list(TIMED_MAIN),
        "dtype": "float32",
        **timed,
        "lm_scale": {"shape": [LM_K, LM_N], **lm},
    }
    print(json.dumps({"kernels": [kernel]}))
    print(f"card: {line}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
