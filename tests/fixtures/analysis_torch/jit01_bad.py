"""JIT01 fixture: host effects inside bodies that a CUDA graph captures
or a trace runs once, across every marking form (with-block, a function
called by name in it, make_graphed_callables, call-form trace, bare and
partial decorators, lru_cache'd factory, partial and lambda arguments,
a module class's forward)."""
import functools
import time

import numpy as np
import torch

EXAMPLE = (torch.zeros(4),)


def captured_block(graph, x):
    with torch.cuda.graph(graph):
        y = x * 2
        print("capturing", y)  # capture time only
    return y


def called_in_capture(x):
    return x + time.time()  # baked in at capture time


def capture_by_name(graph, x):
    with torch.cuda.graph(graph):
        out = called_in_capture(x)
    return out


def graphed(x):
    return x.cpu()  # a device-to-host copy: the capture refuses it


def other(x):
    return x + 1


graphed_pair = torch.cuda.make_graphed_callables((graphed, other), (EXAMPLE, EXAMPLE))


def traced(x):
    return x.tolist()  # pinned to the values seen at trace time


traced_fn = torch.jit.trace(traced, EXAMPLE)


@functools.partial(torch.jit.trace, example_inputs=EXAMPLE)
def partial_decorated(x):
    torch.cuda.synchronize()  # a host sync
    return x


@torch.fx.symbolic_trace
def decorated(x):
    print("tracing")  # trace time only
    return x


@functools.lru_cache(maxsize=None)
def make_step():
    def step(x):
        return x + np.random.rand()  # host RNG baked in at trace time

    return torch.fx.symbolic_trace(step)


def scaled(x, k):
    breakpoint()  # trace time only
    return x * k


scaled_fn = torch.jit.trace(functools.partial(scaled, k=2), EXAMPLE)

mapped = torch.jit.trace(lambda x: x.sum().item(), EXAMPLE)


class Net(torch.nn.Module):
    def forward(self, x):
        return x.numpy()  # a host copy inside the exported graph


exported = torch.export.export(Net(), EXAMPLE)
