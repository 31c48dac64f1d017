#!/usr/bin/env python3
"""A kernel's times in two checkouts of the port, in turns, on one NVIDIA
GPU: the way to compare a change to ``flash_attention.cu`` (the default) or
``ssd_scan.cu`` (``--kernel ssd_scan``) with the commit before it.

    mkdir -p build/ab_parent && git archive <commit> | tar -x -C build/ab_parent
    python3 profile_flash_ab.py build/ab_parent [--kernel ssd_scan]

``build/`` is git-ignored, so the other checkout goes there. The script runs
one process per checkout in the order other, this, this, other, so that
a drift of the card's clock during the call falls on both. Each process imports ``repro_torch`` from its own checkout, which
builds that checkout's ``flash_attention.cu`` into its own ``build/``, and
times the wrapper at ``chip_smoke.py`` phase 9's four timed shapes (smollm-
135m, zamba2-7b, qwen2-moe-a2.7b and phi-3-vision-4.2b, causal) in f32 and
bf16 on the same inputs, made from one seed: device time inside a CUDA
graph, eager time and host time per call, with the helpers of this
checkout's ``chip_smoke.py``. It holds each result against the plain
version at phase 9's tolerance, and prints per shape and dtype each turn's
device time, the mean of each checkout's turns, their ratio, and the share
of the bound. With ``--kernel ssd_scan`` it times the wrapper at phase 13's
two shapes instead (zamba2-7b's loss (1, 112, 2048, 64), chunk 256, and
serve prefill (8, 112, 128, 64), chunk 64, B and C as stride-0 head views)
in f32 and bf16, holds y against the model's ``ssd_chunked`` (f32) or
``ref_ssd`` (bf16) at phase 13's tolerances, and also prints the device
launches per call (from a CUDA graph). Exits non-zero without CUDA or when
a process fails.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def child(tree: Path, kernel: str) -> None:
    """Times this process's checkout (``tree``) and prints one JSON line."""
    sys.path.insert(0, str(tree / "src"))
    import repro_torch
    if kernel == "ssd_scan":
        child_ssd(repro_torch)
        return
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import ref_attention

    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    rows = []
    for B, H, KV, Sq, Sk, hd in (cs.FLASH_SHAPES[0], cs.FLASH_ZAMBA, cs.FLASH_MOE, cs.FLASH_VLM):
        q32 = torch.randn(B, H, Sq, hd, generator=gen, device=dev)
        k32 = torch.randn(B, KV, Sk, hd, generator=gen, device=dev)
        v32 = torch.randn(B, KV, Sk, hd, generator=gen, device=dev)
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            call = lambda: flash_attention(q, k, v, causal=True)  # noqa: E731
            err = (call().float() - ref_attention(q, k, v, True).float()).abs().max().item()
            rows.append({"shape": [B, H, KV, Sq, Sk, hd], "dtype": name, "max_abs_err": err,
                         "ok": err <= cs.FLASH_TOL[name],
                         "device_ms": cs.graph_ms(call, inner=10),
                         "ms": cs.time_ms(call, reps=10),
                         "host_ms": cs.host_ms(call, inner=100, reps=10)})
            torch.cuda.empty_cache()
    print(json.dumps({"package": repro_torch.__file__, "rows": rows}))


def child_ssd(repro_torch) -> None:
    """The ssd_scan rows of ``child``: phase 13's two shapes in both dtypes."""
    from repro_torch.kernels import device_launches
    from repro_torch.kernels.ref import ref_ssd
    from repro_torch.kernels.ssd_scan import ssd_scan

    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = []
    for label, (B, H, L, P, N, chunk) in (("loss", cs.SSD_LOSS), ("serve", cs.SSD_SERVE)):
        x, a, b, c = cs._ssd_inputs(gen, B, H, L, P, N, dev, shared_bc=True)
        want = cs._chunked(x, a, b, c, chunk)[0]
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            xx, bb, cc = ((x, b, c) if dtype == torch.float32 else
                          (x.to(dtype), b[:, :1].to(dtype).expand(B, H, L, N),
                           c[:, :1].to(dtype).expand(B, H, L, N)))
            call = lambda: ssd_scan(xx, a, bb, cc, chunk, return_state=True)  # noqa: E731
            ref = want if dtype == torch.float32 else ref_ssd(xx, a, bb, cc)
            tol = cs.SSD_TOL if dtype == torch.float32 else cs.SSD_BF16_TOL
            diff = (call()[0].float() - ref.float()).abs()
            rows.append({"shape": [B, H, L, P, N], "chunk": chunk, "label": label,
                         "dtype": name, "max_abs_err": diff.max().item(),
                         "ok": bool((diff <= tol["atol"] + tol["rtol"] * ref.float().abs()).all()),
                         "device_ms": cs.graph_ms(call, inner=10),
                         "ms": cs.time_ms(call, inner=5),
                         "host_ms": cs.host_ms(call, inner=100, reps=10),
                         "device_launches": device_launches(call)})
            torch.cuda.empty_cache()
    print(json.dumps({"package": repro_torch.__file__, "rows": rows}))


def run_turn(tree: Path, kernel: str) -> dict:
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", str(tree),
                          "--kernel", kernel], capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"profile_flash_ab: the process for {tree} exited {out.returncode}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    if not str(Path(got["package"]).resolve()).startswith(str(tree / "src")):
        raise SystemExit(f"profile_flash_ab: {tree}'s process imported {got['package']}")
    return got


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="root of the checkout to compare with this one")
    ap.add_argument("--kernel", choices=("flash_attention", "ssd_scan"),
                    default="flash_attention", help="the kernel to time (default flash)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_flash_ab: needs an NVIDIA GPU (torch.cuda.is_available() is "
                         "false)")
    if args.child:
        child(args.other.resolve(), args.kernel)
        return
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    other, this = args.other.resolve(), ROOT
    if not (other / "src" / "repro_torch").is_dir():
        raise SystemExit(f"profile_flash_ab: {other} holds no src/repro_torch")
    print(f"card: {cs.card_line()}")
    turns = {"other": [], "this": []}
    for label, tree in (("other", other), ("this", this), ("this", this), ("other", other)):
        turns[label].append(run_turn(tree, args.kernel))
        print(f"turn {label} ({tree}) done", flush=True)
    failed = [(label, r["shape"], r["dtype"], r["max_abs_err"])
              for label, runs in turns.items() for run in runs for r in run["rows"]
              if not r["ok"]]
    if args.kernel == "ssd_scan":
        report_ssd(cs, turns)
    else:
        report_flash(cs, turns)
    if failed:
        raise SystemExit(f"profile_flash_ab: results past the tolerance: {failed}")


def report_ssd(cs, turns) -> None:
    for i, row in enumerate(turns["this"][0]["rows"]):
        B, H, L, P, N = row["shape"]
        bound = cs.ssd_bound_ms(B, H, L, P, N, row["chunk"], True,
                                4 if row["dtype"] == "float32" else 2)[0]
        line = [f"ssd_scan {row['label']} {tuple(row['shape'])} chunk {row['chunk']} "
                f"{row['dtype']}:"]
        mean = {}
        for label in ("other", "this"):
            runs = [run["rows"][i] for run in turns[label]]
            dev = [r["device_ms"] for r in runs]
            mean[label] = statistics.mean(dev)
            line.append(f"{label} device {' / '.join(f'{d:.4f}' for d in dev)} ms "
                        f"(mean {mean[label]:.4f}, {bound / mean[label]:.1%} of the bound "
                        f"{bound:.4f}), eager {statistics.mean(r['ms'] for r in runs):.4f} ms, "
                        f"host {statistics.mean(r['host_ms'] for r in runs) * 1e3:.2f} us, "
                        f"{runs[0]['device_launches']} device launches;")
        line.append(f"other / this {mean['other'] / mean['this']:.2f}x")
        print(" ".join(line))


def report_flash(cs, turns) -> None:
    for i, row in enumerate(turns["this"][0]["rows"]):
        B, H, KV, Sq, Sk, hd = row["shape"]
        size, peak = ((4, cs.PEAK_TF32X3_FLOP_PER_S) if row["dtype"] == "float32"
                      else (2, cs.PEAK_BF16_FLOP_PER_S))
        bound = cs.flash_bound_ms(B, H, KV, Sq, Sk, hd, True, size, peak)[0]
        line = [f"flash causal {tuple(row['shape'])} {row['dtype']}:"]
        mean = {}
        for label in ("other", "this"):
            runs = [run["rows"][i] for run in turns[label]]
            dev = [r["device_ms"] for r in runs]
            mean[label] = statistics.mean(dev)
            line.append(f"{label} device {' / '.join(f'{d:.4f}' for d in dev)} ms "
                        f"(mean {mean[label]:.4f}, {bound / mean[label]:.1%} of the bound "
                        f"{bound:.4f}), eager {statistics.mean(r['ms'] for r in runs):.4f} ms, "
                        f"host {statistics.mean(r['host_ms'] for r in runs) * 1e3:.2f} us;")
        line.append(f"other / this {mean['other'] / mean['this']:.2f}x")
        print(" ".join(line))


if __name__ == "__main__":
    main()
