"""The whole (arch x shape x mesh) dry-run sweep of the port.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_all [--outdir DIR]
        [--jobs N] [--force] [--mesh single|multi|both] [--archs a,b]
        [--shapes s,t]

Each combination runs ``python -m repro_torch.launch.dryrun`` in its own
subprocess (each starts its own fake process group of 256 or 512 ranks),
writing one JSON per combination into ``--outdir`` (by default
``build/dryrun_torch/``, which git ignores; the JAX package's results
directory is not written). A result already ``ok`` is skipped unless
``--force``. The counterpart of the JAX package's ``launch/dryrun_all.py``,
with its flags.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from repro_torch.configs import ASSIGNED_ARCHS

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
SRC = Path(__file__).resolve().parents[2]
OUTDIR = SRC.parent / "build" / "dryrun_torch"


def result_path(outdir: Path, arch, shape, mesh) -> Path:
    return outdir / f"{arch}_{shape}_{mesh}.json"


def run_one(outdir: Path, arch, shape, multi_pod, timeout=3600) -> bool:
    mesh = "multi" if multi_pod else "single"
    out = result_path(outdir, arch, shape, mesh)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--out", str(out)]
    if multi_pod:
        cmd.append("--multi-pod")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(SRC), env.get("PYTHONPATH")]))
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env)
        ok = proc.returncode == 0
        if not ok and not out.exists():
            out.write_text(json.dumps({"arch": arch, "shape": shape, "mesh": mesh, "ok": False,
                                       "error": proc.stderr[-2000:]}))
    except subprocess.TimeoutExpired:
        ok = False
        out.write_text(json.dumps({"arch": arch, "shape": shape, "mesh": mesh, "ok": False,
                                   "error": f"timeout after {timeout}s"}))
    print(f"[{'OK ' if ok else 'FAIL'}] {arch} x {shape} x {mesh} ({time.time() - t0:.0f}s)",
          flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--outdir", default=str(OUTDIR))
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--archs", default=None, help="comma list")
    ap.add_argument("--shapes", default=None, help="comma list")
    args = ap.parse_args(argv)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = args.archs.split(",") if args.archs else list(ASSIGNED_ARCHS)
    shapes = args.shapes.split(",") if args.shapes else SHAPES
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    work = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                p = result_path(outdir, arch, shape, "multi" if mp else "single")
                if p.exists() and not args.force:
                    try:
                        if json.loads(p.read_text()).get("ok"):
                            continue
                    except ValueError:
                        pass
                work.append((arch, shape, mp))
    print(f"{len(work)} combos to run", flush=True)
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        results = list(ex.map(lambda w: run_one(outdir, *w), work))
    ok = sum(results)
    print(f"done: {ok}/{len(work)} ok in {time.time() - t0:.0f}s")
    return 0 if ok == len(work) else 1


if __name__ == "__main__":
    sys.exit(main())
