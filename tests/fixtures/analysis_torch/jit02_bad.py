"""JIT02 fixture: captured and traced bodies mutating closed-over or
global state."""
import torch

EXAMPLE = (torch.zeros(4),)
_CACHE = {}


def memoized(x):
    _CACHE["last"] = x  # trace-time-only write to module state
    return x


memoized_fn = torch.jit.trace(memoized, EXAMPLE)


def make_counter(graph, x):
    count = [0]

    def step(v):
        count[0] += 1  # runs at capture, never on a replay
        return v + count[0]

    with torch.cuda.graph(graph):
        y = step(x)
    return y


@torch.fx.symbolic_trace
def uses_global(x):
    global _CACHE  # any global statement in a traced body
    return x


def records_in_block(graph, stats, x):
    with torch.cuda.graph(graph):
        stats.calls = 1  # set once at capture
        y = x + 1
    return y
