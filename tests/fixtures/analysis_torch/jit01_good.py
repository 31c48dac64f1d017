"""JIT01 fixture: pure captured and traced bodies; host effects outside
them are fine, torch.vmap runs its body on every call, and a locally
bound ``print`` is not the builtin."""
import time

import torch

EXAMPLE = (torch.zeros(4),)


def pure_step(x):
    return torch.tanh(x) * 2


traced = torch.jit.trace(pure_step, EXAMPLE)


def capture_and_time(graph, static_x):
    t0 = time.time()  # outside the captured block
    with torch.cuda.graph(graph):
        static_y = pure_step(static_x)
    graph.replay()
    print("took", time.time() - t0, static_y.sum().item())
    return static_y


def side_stream(stream, x):
    with torch.cuda.stream(stream):  # not a capture
        return x.sum().item()


mapped = torch.vmap(lambda x: print(x) or x)
mapped_func = torch.func.vmap(lambda x: x.tolist())


def shadowed_print(x):
    def body(v):
        def print(*a):  # noqa: A001
            return None

        print(v)
        return v + 1

    return torch.jit.trace(body, EXAMPLE)(x)
