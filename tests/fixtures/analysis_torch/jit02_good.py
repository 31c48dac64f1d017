"""JIT02 fixture: captured and traced bodies that write only to their
own locals and to what they are passed."""
import torch

EXAMPLE = (torch.zeros(4), torch.zeros(4))


def into_out(x, out):
    out[...] = x * 2  # the caller's buffer: a parameter
    return out


traced = torch.jit.trace(into_out, EXAMPLE)


def capture(graph, static_x):
    with torch.cuda.graph(graph):
        cache = {}
        cache["y"] = static_x + 1
        static_y = cache["y"]
    return static_y
