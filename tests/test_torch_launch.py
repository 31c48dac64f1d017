"""The one launch path of the port's kernel wrappers (``kernels/build.py::launch``).

Every wrapper launches its kernel through ``launch``, which makes the
tensor's device current where it is not, reads that device's current
stream through a private PyTorch accessor, calls the kernel's C entry
point and counts the launch. On the CPU the wrappers are read for that;
on a card (marker ``cuda``) the stream handle is held against
``torch.cuda.current_stream(dev).cuda_stream``, on the default stream and
on a side stream, each wrapper is launched on ``cuda:1`` while ``cuda:0``
is current (where there are two cards), and a CUDA graph of the wrappers
is held against their eager results:

    python -m pytest -q -m cuda tests/test_torch_launch.py
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.kernels as K
from repro_torch.kernels import LAUNCHES, KERNELS, reset_launches

KERNEL_DIR = Path(K.__file__).resolve().parent


def _calls(tree, name: str) -> list:
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and getattr(n.func, "id", getattr(n.func, "attr", None)) == name]


@pytest.mark.parametrize("name", KERNELS)
def test_every_wrapper_launches_through_the_helper(name):
    """One ``launch("<name>", ...)`` call in the wrapper's module, and no
    launch path of its own: no stream read, no device guard, no count."""
    tree = ast.parse((KERNEL_DIR / f"{name}.py").read_text())
    launches = _calls(tree, "launch")
    assert [c.args[0].value for c in launches] == [name]
    used = {getattr(n, "id", getattr(n, "attr", None)) for n in ast.walk(tree)}
    for own in ("current_stream", "cuda_stream", "on_device", "LAUNCHES", f"{name}_launch"):
        assert own not in used, f"kernels/{name}.py still has its own {own}"


# ----------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels cannot run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(dev) -> dict:
    """{kernel: (call, tolerance)}: each wrapper at a small shape on ``dev``,
    at its test's f32 gate against the plain version."""
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0, shift=0.0):
        a = shift + scale * rng.standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    x2, w4 = t(4, 1000), torch.softmax(t(4), 0)
    q, k, v = t(1, 4, 64, 64), t(1, 2, 64, 64), t(1, 2, 64, 64)
    xs, a = t(1, 2, 64, 16), -t(1, 2, 64).abs()
    bs, cs = t(1, 2, 64, 8), t(1, 2, 64, 8)
    xn, zn, wn = t(8, 256), t(8, 256), t(256, scale=0.1, shift=1.0)
    m, vv = t(1000), t(1000).abs()
    return {
        "fedavg": (lambda: K.fedavg(x2, w4), 1e-5),
        "fused_aggregate": (lambda: K.fused_aggregate(
            x2, w4, torch.arange(4.0, device=dev), m, vv, mode="fedadam", beta=0.5,
            normalizer=1.0), 1e-5),
        "flash_attention": (lambda: K.flash_attention(q, k, v), 2e-5),
        "rmsnorm": (lambda: K.rmsnorm(xn, wn), 1e-5),
        "gated_rmsnorm": (lambda: K.gated_rmsnorm(xn, zn, wn), 2e-5),
        "ssd_scan": (lambda: K.ssd_scan(xs, a, bs, cs, chunk=16), 5e-4),
    }


def _flat(out) -> torch.Tensor:
    outs = out if isinstance(out, tuple) else (out,)
    return torch.cat([o.detach().float().reshape(-1).cpu() for o in outs])


@pytest.mark.cuda
def test_launch_reads_the_current_stream(cuda_device):
    """The raw handle ``launch`` passes is the current stream's, on the
    default stream and inside ``torch.cuda.stream(side)``; a wrapper called
    there runs on the side stream."""
    idx = cuda_device.index
    assert torch._C._cuda_getDevice() == torch.cuda.current_device()
    assert (torch._C._cuda_getCurrentRawStream(idx)
            == torch.cuda.current_stream(cuda_device).cuda_stream)
    x = torch.randn(64, 1024, device=cuda_device)
    w = torch.rand(1024, device=cuda_device)
    want = K.rmsnorm(x, w)
    side = torch.cuda.Stream(device=cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        assert torch._C._cuda_getCurrentRawStream(idx) == side.cuda_stream
        assert (torch._C._cuda_getCurrentRawStream(idx)
                == torch.cuda.current_stream(cuda_device).cuda_stream)
        got = K.rmsnorm(x, w)
    side.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_wrappers_launch_on_a_second_card_while_the_first_is_current(cuda_device):
    """Each wrapper on ``cuda:1`` tensors, with ``cuda:0`` current, launches
    once there, leaves ``cuda:0`` current and matches its plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: only one is visible")
    dev1 = torch.device("cuda", 1)
    plain = _inputs(torch.device("cpu"))
    with torch.cuda.device(0):
        for name, (call, tol) in _inputs(dev1).items():
            reset_launches()
            got = call()
            torch.cuda.synchronize(dev1)
            assert LAUNCHES[name] == 1, name
            assert torch.cuda.current_device() == 0, name
            outs = got if isinstance(got, tuple) else (got,)
            assert all(o.device == dev1 for o in outs), name
            torch.testing.assert_close(_flat(got), _flat(plain[name][0]()), rtol=0, atol=tol)


@pytest.mark.cuda
def test_wrappers_capture_in_a_cuda_graph(cuda_device):
    """Each wrapper captured in a CUDA graph, then replayed, gives its eager
    result: the launch reads the capture stream."""
    calls = _inputs(cuda_device)
    eager = {name: _flat(call()) for name, (call, _) in calls.items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for name in eager:
            calls[name][0]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = {name: calls[name][0]() for name in eager}
    graph.replay()
    torch.cuda.synchronize()
    for name, want in eager.items():
        torch.testing.assert_close(_flat(outs[name]), want, rtol=0, atol=0)
