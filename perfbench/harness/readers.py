"""What each metric reads from a run: the quantities behind the reader
files ``perfbench/end_to_end/<name>.py`` and ``perfbench/metrics/<name>.py``
(a metric split by the end-to-end metric it moves shares its quantity).
Each takes the run's context and returns a number, or None where the run
has nothing to read."""

from perfbench.harness.arith import PEAK_BYTES_PER_S, PEAK_F32_FLOP_PER_S
from perfbench.harness.trace import kernel_seconds


def setup_s(ctx):
    """Seconds from the process's start to the window's first round:
    imports, the port's build and init, the harness's weights, the data,
    the kernels' load (and build, on a checkout's first run) and the warm
    rounds."""
    return ctx["setup_s"]


def train_tokens_per_s(ctx):
    """Tokens trained in the window (rows x seq x tau of every task a
    round gave clients) over the window's wall time, whole rounds."""
    return ctx["tokens"] / ctx["window_s"]


def peak_mem_gib(ctx):
    """The card's peak allocated memory over the window."""
    return ctx["window_peak_bytes"] / 2**30


def round_host_ms(ctx):
    """A round's wall time less its cohort, fold and eval spans: the round
    loop's own time (allocation, batch assembly, the cost model's draws)."""
    return 1e3 * (ctx["window_s"] - sum(ctx["spans"].values())) / ctx["rounds"]


def _span_ms(ctx, name):
    seconds = ctx["spans"].get(name)
    return None if seconds is None else 1e3 * seconds / ctx["rounds"]


def cohort_ms(ctx):
    """``VmapBackend.run_cohort`` (a tau > 1 task's rows of local SGD steps,
    a tau = 1 task's AdamW step) a round, over its tasks."""
    return _span_ms(ctx, "cohort")


def fold_ms(ctx):
    """The fedavg aggregator's ``aggregate_params`` (the ``fedavg`` kernel
    over the flattened cohort) a round; nothing where no task folds."""
    return _span_ms(ctx, "fold")


def eval_ms(ctx):
    """The tasks' next-token eval probes a round."""
    return _span_ms(ctx, "eval")


def _roofline(ctx, kernel, stem):
    nbytes = ctx["bytes"].get(kernel)
    seconds = kernel_seconds(ctx["events"], stem) if ctx["events"] else 0.0
    if not nbytes or not seconds:
        return None
    return 100 * nbytes / PEAK_BYTES_PER_S / seconds


def fedavg_roofline(ctx):
    """The fold kernel's share of its bytes bound over the profiled rounds:
    the bytes of every call (each input read and each output written once)
    at 3.35 TB/s over the device time of its launches."""
    return _roofline(ctx, "fedavg", "fedavg_")


def device_idle_pct(ctx):
    """The share of the profiled rounds in which no kernel, copy or set ran
    (the profiler's cost per operation included)."""
    t = ctx["trace"]
    return 100 * (1 - t.busy_s / t.window_s)


def mfu(ctx):
    """The FLOPs the window's trained tokens need (matmuls, attention's kept
    pairs, the SSD's chunk products; no recompute, no probe) over the
    window's wall time, against 164.9 TFLOP/s."""
    return 100 * ctx["flops"] / ctx["window_s"] / PEAK_F32_FLOP_PER_S
