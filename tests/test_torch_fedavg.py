"""The port's fedavg fold against the Pallas kernel it replaces.

On the CPU the wrapper takes its plain version; it is held against
``fedavg_pallas(..., interpret=True)`` and ``ref.ref_fedavg`` on the same
numpy inputs, at the gates of tests/test_kernels.py (atol 1e-5 f32,
5e-2 bf16). The CUDA kernel runs only on a card (marker ``cuda``), where
it is held against the same plain version:

    python -m pytest -q -m cuda tests/test_torch_fedavg.py tests/test_torch_scenario.py
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.fedavg import fedavg_pallas
from repro.kernels.ref import ref_fedavg as jax_ref_fedavg
from repro_torch.kernels import LAUNCHES, fedavg, reset_launches
from repro_torch.kernels.ref import ref_fedavg

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, N)).astype(np.float32)
    r = rng.standard_normal(K).astype(np.float32)
    w = np.exp(r - r.max())
    return x, (w / w.sum()).astype(np.float32)


def _to_torch(a, dtype):
    """numpy f32 -> torch ``dtype``, rounding exactly as JAX's astype."""
    if dtype == "bfloat16":
        bits = a.astype(ml_dtypes.bfloat16).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("K,N,blk", [(1, 1, 128), (4, 1000, 256), (3, 1738, 512),
                                     (8, 6922, 2048), (16, 4096, 2048), (7, 12345, 512)])
@pytest.mark.parametrize("x_dtype,w_dtype", [("float32", "float32"),
                                             ("bfloat16", "bfloat16"),
                                             ("bfloat16", "float32")])
def test_fedavg_matches_pallas(K, N, blk, x_dtype, w_dtype):
    x, w = _inputs(K, N, seed=K * 7919 + N)
    xj, wj = jnp.asarray(x).astype(_JNP[x_dtype]), jnp.asarray(w).astype(_JNP[w_dtype])
    want_kernel = np.asarray(fedavg_pallas(xj, wj, blk=blk, interpret=True), np.float32)
    got = fedavg(_to_torch(x, x_dtype), _to_torch(w, w_dtype))
    assert got.dtype == _TORCH[x_dtype] and got.shape == (N,)
    atol = 1e-5 if x_dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(), want_kernel, atol=atol)
    if x_dtype == w_dtype:
        want_ref = np.asarray(jax_ref_fedavg(xj, wj), np.float32)
        np.testing.assert_allclose(got.float().numpy(), want_ref, atol=atol)


def test_fedavg_cpu_is_the_plain_version():
    x, w = _inputs(5, 777, seed=3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    reset_launches()
    torch.testing.assert_close(fedavg(xt, wt), ref_fedavg(xt, wt), rtol=0, atol=0)
    assert LAUNCHES["fedavg"] == 0


@pytest.mark.parametrize("stacked,weights,err", [
    (torch.zeros(4), torch.zeros(4), ValueError),                  # not (K, N)
    (torch.zeros(2, 3, 4), torch.zeros(2), ValueError),
    (torch.zeros(4, 8), torch.zeros(3), ValueError),              # K mismatch
    (torch.zeros(4, 8), torch.zeros(4, 1), ValueError),
    (torch.zeros(4, 8, dtype=torch.int32), torch.zeros(4), TypeError),
    (torch.zeros(4, 8), torch.zeros(4, dtype=torch.int64), TypeError),
    (torch.zeros(8, 4).t(), torch.zeros(4), ValueError),          # not contiguous
])
def test_fedavg_validation(stacked, weights, err):
    with pytest.raises(err):
        fedavg(stacked, weights)


def test_fedavg_validation_matches_pallas():
    """The shape and dtype errors are the reference's own."""
    for st, w, err in [(np.zeros(4), np.zeros(4), ValueError),
                       (np.zeros((4, 8)), np.zeros(3), ValueError),
                       (np.zeros((4, 8), np.int32), np.zeros(4), TypeError)]:
        with pytest.raises(err):
            fedavg_pallas(jnp.asarray(st), jnp.asarray(w), interpret=True)
        with pytest.raises(err):
            fedavg(torch.from_numpy(st), torch.from_numpy(w))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the GPU machine")
    return torch.device("cuda")


def _cuda_inputs(K, N, seed, dev):
    x, w = _inputs(K, N, seed)
    return torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)


_CUDA_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2, torch.float16: 5e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(1, 1), (1, 1738), (3, 3786), (8, 6922), (16, 2049),
                                 (5, 4096), (2, 8192), (8, 2**20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_fedavg_cuda_kernel_matches_plain(cuda_device, K, N, dtype):
    """Scalar path (ragged N) and 16-byte path (N a multiple of 8)."""
    x32, w = _cuda_inputs(K, N, K + N, cuda_device)
    x = x32.to(dtype)
    reset_launches()
    got = fedavg(x, w)
    torch.cuda.synchronize()
    assert LAUNCHES["fedavg"] == 1
    assert got.dtype == dtype and got.shape == (N,) and got.device.type == "cuda"
    torch.testing.assert_close(got.float(), ref_fedavg(x, w).float(), rtol=0,
                               atol=_CUDA_TOL[dtype])


@pytest.mark.cuda
def test_fedavg_cuda_mixed_dtypes_promote(cuda_device):
    """bf16 cohort with f32 weights: promoted to f32, cast back to bf16;
    bf16 weights with an f32 cohort are widened and never demote it."""
    x32, w = _cuda_inputs(6, 3000, 1, cuda_device)
    xb = x32.to(torch.bfloat16)
    got = fedavg(xb, w)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref_fedavg(xb.float(), w).to(torch.bfloat16).float(),
                               rtol=0, atol=5e-2)
    wb = w.to(torch.bfloat16)
    got = fedavg(x32, wb)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref_fedavg(x32, wb.float()), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_fedavg_cuda_misaligned_rows_take_scalar_path(cuda_device):
    K, N = 4, 4096
    x = torch.empty(K * N + 1, device=cuda_device)[1:].view(K, N)
    x.copy_(_cuda_inputs(K, N, 2, cuda_device)[0])
    w = _cuda_inputs(K, 1, 3, cuda_device)[1]
    torch.testing.assert_close(fedavg(x, w), ref_fedavg(x, w), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_fedavg_cuda_refuses_what_it_cannot_take(cuda_device):
    x, w = _cuda_inputs(3, 10, 4, cuda_device)
    with pytest.raises(TypeError):
        fedavg(x.double(), w)
    with pytest.raises(ValueError):
        fedavg(x, w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("K,normalizer", [(4, None), (4, 2.5), (3, 1.75), (8, None)])
def test_qfedavg_fold_runs_the_kernel_once_on_cuda(cuda_device, K, normalizer):
    """qfedavg (q=1) under the vmap backend: the rescaled weights and the
    rescaled normaliser reach the kernel in one launch, and the fold
    agrees with the same rule's plain fold on the CPU."""
    from repro_torch.api.aggregator import get_aggregator
    from repro_torch.api.backend import get_backend

    rng = np.random.default_rng(K)
    cohort = {"a": rng.standard_normal((K, 33, 7)).astype(np.float32),
              "b": rng.standard_normal((K, 129)).astype(np.float32)}
    w = torch.from_numpy(rng.uniform(0.5, 2.0, K).astype(np.float32))
    agg = get_aggregator("qfedavg", {"q": 1.0}, backend=get_backend("vmap", device=cuda_device))
    reset_launches()
    got, _ = agg.aggregate({k: torch.from_numpy(v).to(cuda_device) for k, v in cohort.items()},
                           w.to(cuda_device), None, normalizer=normalizer)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"fedavg": 1}
    plain = get_aggregator("qfedavg", {"q": 1.0}, backend=get_backend("vmap", device="cpu"))
    want, _ = plain.aggregate({k: torch.from_numpy(v) for k, v in cohort.items()}, w, None,
                              normalizer=normalizer)
    for k in want:
        assert got[k].device.type == "cuda"
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=1e-5)
