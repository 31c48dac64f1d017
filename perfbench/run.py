"""Run one cell of the benchmark once, on the card this process is started
on, and print its result as the last line of standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the result's metrics are the end-to-end ones
(``perfbench/end_to_end/<name>.py``); with ``--trace 1`` the per-layer ones
(``perfbench/metrics/<name>.py``), read from harness spans in the window
and from counters and a ``torch.profiler`` trace of rounds profiled after
it. After the window the program's
state is freed and the plain reference follows the warm rounds; the
numbers compared, each beside its limit, end standard error and the
result line. Exits with 2 and prints no result without enough cards, and
with 3 if JAX or the JAX package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# every cache of the program in fixed directories of the checkout
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def readers(folder: str, names=None) -> dict:
    """name -> module of the reader files ``perfbench/<folder>/<name>.py``
    (every one there where ``names`` is None)."""
    paths = (sorted((BENCH / folder).glob("*.py")) if names is None
             else [BENCH / folder / f"{n}.py" for n in names])
    out = {}
    for path in paths:
        spec = importlib.util.spec_from_file_location(f"perfbench_{folder}_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def metric_names(cell: str, trace: bool) -> list:
    """The metrics ``BENCHMARK.json`` gives ``cell``: the end-to-end ones that
    list it (or list no cells); with ``trace``, the per-layer ones that list
    it, or that list no cells and move an end-to-end metric it reports."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    reports = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    if not trace:
        return sorted(reports)
    return sorted(m["name"] for m in bench["per_layer"]
                  if cell in m.get("workloads", [cell] if m["moves"] in reports else []))


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, device, names=None) -> dict:
    """One run of ``cell``: set-up, the window, the reference and the
    comparison; ``names`` are the metrics to read (every reader of the
    kind where None). Returns the result (without ``device``'s card
    fields)."""
    from perfbench.harness import check
    from perfbench.harness import trace as tracing
    from perfbench.harness.session import Session
    from perfbench.reference import mmfl

    session = Session(cell, seed, seconds, trace, device, STARTED)
    session.build()
    window_s = session.run()
    ctx = {"setup_s": session.setup_s, "window_s": window_s, "rounds": session.window["rounds"],
           "tokens": session.window["tokens"], "flops": session.window["flops"],
           "window_peak_bytes": session.peak_bytes, "spans": session.spans,
           "bytes": session.bytes, "trace": None, "events": None}
    result = {"attempted": session.window["attempted"], "failed": session.window["failed"]}
    dev = {"memory_peak_bytes": max(session.setup_peak, session.peak_bytes)}
    if trace:
        ctx["events"] = tracing.events(session.profiler)
        ctx["trace"] = reading = tracing.read(ctx["events"])
        dev.update(busy_s=reading.busy_s, window_s=reading.window_s)
        for stem in ("fedavg_",):
            print(f"kernels {stem}: {sorted(tracing.kernels(ctx['events'], stem))}",
                  file=sys.stderr)
        result["breakdown"] = {"device_ops": [[k, v] for k, v in reading.device_ops.items()],
                               "idle_gaps": [[k, v] for k, v in reading.idle_gaps]}
    metrics = {}
    for name, mod in readers("metrics" if trace else "end_to_end", names).items():
        value = mod.read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": mod.UNIT}
    prog = session.readings
    session.free()
    marks = dict(session.marks, window=window_s, rounds=ctx["rounds"], tokens=ctx["tokens"],
                 tokens_per_s=ctx["tokens"] / max(window_s, 1e-9))
    tasks = cell.tasks()
    t0 = time.perf_counter()
    ref = mmfl.follow(tasks, cell.scenario, seed, device, cell.warm_rounds)
    marks["reference"] = time.perf_counter() - t0
    print("seconds " + " ".join(f"{k} {v:.2f}" for k, v in marks.items()), file=sys.stderr)
    numbers = check.compare(prog, ref, tasks)
    result.update(correct=check.verdict(numbers, cell.limits), metrics=metrics, device=dev,
                  compared={k: {"value": numbers[k], "limit": cell.limits[k]}
                            for k in check.names(tasks)})
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness.cell import load

    cell = load(args.workload)
    chips = cell.workload.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                      metric_names(args.workload, bool(args.trace)))
    found = loaded_forbidden()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                        "count": chips, **result["device"]}
    for k, v in result["compared"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    order = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "compared")
    print(json.dumps({k: result[k] for k in order if k in result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
