"""The readings that a cell's limits are set from, on the card at the
cell's own size.

    python3 perfbench/control.py --workload <cell> --seeds 11 12 ... \\
        [--control 11 12 13] [--faults 11 12 13] [--out chiprun_out/readings.jsonl]

For each of ``--seeds``: the program's warm rounds against the reference
(the lower readings). For each of ``--control``: the reference computed
with TF32 on, put in the program's place (the control: the nearest
precision below the configuration's f32). For each of ``--faults``: the
reference with a fault planted, in the program's place: ``half`` (half of
each batch left out, the mean taken over the rest) and ``answer`` (the
probe's first token of one row altered where it is produced). A state
left unchanged reads 1 by ``change_gap`` and needs no run. One JSON line
per reading. The benchmark's own runs never run this.
"""

import contextlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def program(cell, seed: int, device) -> dict:
    """The program's readings of the warm rounds (no window)."""
    from perfbench.harness.session import Session

    session = Session(cell, seed, 0.0, False, device, time.perf_counter())
    session.build()
    session.run()
    readings = session.readings
    session.free()
    return readings


@contextlib.contextmanager
def half_batch():
    """Each batch's first half alone, its weights renormalised."""
    from perfbench.reference import mmfl

    assemble = mmfl.assemble

    def half(*args, **kw):
        batch = assemble(*args, **kw)
        n = batch["client_weights"].shape[0] // 2
        out = {k: v[:n] for k, v in batch.items()}
        out["client_weights"] = out["client_weights"] / out["client_weights"].sum()
        return out

    mmfl.assemble = half
    try:
        yield
    finally:
        mmfl.assemble = assemble


@contextlib.contextmanager
def altered_answer():
    """The probe's first token of row 0 pushed below every other."""
    from perfbench.reference import mmfl

    family = mmfl.family

    class Altered:
        def __init__(self, mod):
            self.mod = mod
            self.init, self.loss = mod.init, mod.loss

        def last_logits(self, params, cfg, batch):
            logits = self.mod.last_logits(params, cfg, batch).clone()
            logits[0, logits[0].argmax()] = logits[0].min() - 1
            return logits

    mmfl.family = lambda cfg: Altered(family(cfg))
    try:
        yield
    finally:
        mmfl.family = family


FAULTS = {"half": half_batch, "answer": altered_answer}


def main(argv=None) -> int:
    import argparse

    import torch

    from perfbench.harness import check
    from perfbench.harness.cell import load
    from perfbench.reference import mmfl

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--faults", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = load(args.workload)
    tasks = cell.tasks()
    out = open(args.out, "a") if args.out else None

    def emit(seed, kind, numbers, t0):
        line = json.dumps({"workload": cell.name, "seed": seed, "kind": kind,
                           "seconds": time.perf_counter() - t0, **numbers})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def reference(seed, tf32=False):
        return mmfl.follow(tasks, cell.scenario, seed, device, cell.warm_rounds, tf32=tf32)

    for seed in dict.fromkeys(args.seeds + args.control + args.faults):
        t0 = time.perf_counter()
        ref = reference(seed)
        emit(seed, "reference", {"seconds_ref": time.perf_counter() - t0}, t0)
        runs = []
        if seed in args.seeds:
            runs.append(("program", lambda: program(cell, seed, device)))
        if seed in args.control:
            runs.append(("control_tf32",
                         lambda: check.as_program(reference(seed, tf32=True), tasks)))
        if seed in args.faults:
            for name, fault in FAULTS.items():
                def planted(fault=fault):
                    with fault():
                        return check.as_program(reference(seed), tasks)
                runs.append((f"fault_{name}", planted))
        for kind, get in runs:
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            got = get()
            emit(seed, kind, check.compare(got, ref, tasks), t0)
        del ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
