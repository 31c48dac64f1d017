"""The port's gated RMSNorm and SSD scan against the Pallas kernels they replace.

On the CPU each wrapper takes its plain version (``ref_gated_rmsnorm``,
``ref_ssd``); it is held against the Pallas kernel in interpret mode
(``gated_rmsnorm_pallas``, ``ssd_scan_pallas``) and against the JAX
package's oracles on the same numpy inputs, at the gates of
tests/test_kernels.py: gated RMSNorm atol 2e-5 f32 (5e-2 bf16, the RMSNorm
gate); the SSD scan atol 5e-4 / rtol 1e-3, chunk invariance 5e-5 / 1e-4.
The final state that ``ssd_scan(..., return_state=True)`` adds is held
against the ``h_fin`` of the JAX package's ``ssd_chunked`` at the scan's
gate. The CUDA kernels (and flash attention at zamba2-7b's head dim 112)
run only on a card (marker ``cuda``):

    python -m pytest -q -m cuda tests/test_torch_ssm_kernels.py tests/test_torch_hybrid.py
"""
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.ref import ref_gated_rmsnorm as jax_ref_gated_rmsnorm
from repro.kernels.ref import ref_ssd as jax_ref_ssd
from repro.kernels.rmsnorm import gated_rmsnorm_pallas
from repro.kernels.ssm_scan import ssd_scan_pallas
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import LAUNCHES, flash_attention, gated_rmsnorm, reset_launches, ssd_scan
from repro_torch.kernels.ref import ref_attention, ref_gated_rmsnorm, ref_ssd

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GATED_TOL = {"float32": 2e-5, "bfloat16": 5e-2}
SSD_TOL = dict(atol=5e-4, rtol=1e-3)
SSD_CHUNK_TOL = dict(atol=5e-5, rtol=1e-4)
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _normal(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def _to_torch(a, dtype):
    """numpy f32 -> torch ``dtype``, rounding exactly as JAX's astype."""
    if dtype == "bfloat16":
        bits = a.astype(ml_dtypes.bfloat16).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(a)


def _np32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


def _ssd_inputs(B, H, L, P, N, seed, shared_bc=False):
    """The inputs of tests/test_kernels.py::test_ssd_scan_sweep, from numpy:
    x scaled 0.5, a = -softplus(normal), b and c scaled 0.3. With
    ``shared_bc`` b and c are one (B, L, N) group broadcast over heads."""
    x = _normal((B, H, L, P), seed, 0.5)
    a = -np.logaddexp(_normal((B, H, L), seed + 1), 0).astype(np.float32)
    bc_shape = (B, 1, L, N) if shared_bc else (B, H, L, N)
    b = np.broadcast_to(_normal(bc_shape, seed + 2, 0.3), (B, H, L, N))
    c = np.broadcast_to(_normal(bc_shape, seed + 3, 0.3), (B, H, L, N))
    return x, a, np.array(b), np.array(c)


# ------------------------------------------------------------ gated RMSNorm

@pytest.mark.parametrize("shape", [(6, 128), (130, 96), (3, 7168), (2, 5, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_rmsnorm_matches_pallas(shape, dtype):
    x, z = _normal(shape, 32), _normal(shape, 33)
    w = _normal(shape[-1:], 34, scale=0.1, shift=1.0)
    got = gated_rmsnorm(_to_torch(x, dtype), _to_torch(z, dtype), _to_torch(w, dtype))
    assert got.shape == shape and got.dtype == _TORCH[dtype]
    xj, zj, wj = (jnp.asarray(a).astype(_JNP[dtype]) for a in (x, z, w))
    want = gated_rmsnorm_pallas(xj, zj, wj, blk_rows=64, interpret=True)
    np.testing.assert_allclose(_np32(got), _np32(want), atol=GATED_TOL[dtype])
    np.testing.assert_allclose(_np32(got), _np32(jax_ref_gated_rmsnorm(xj, zj, wj)),
                               atol=GATED_TOL[dtype])


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_gated_rmsnorm_matches_jax_model_gate(eps):
    """The kernel's contract equals Mamba2's unfused gate of the JAX model,
    ``rms_norm(y * silu(z))``."""
    from repro.models.layers import rms_norm as jax_rms_norm

    x, z, w = _normal((5, 96), 35), _normal((5, 96), 36), _normal((96,), 37)
    got = gated_rmsnorm(*(torch.from_numpy(a) for a in (x, z, w)), eps)
    want = jax_rms_norm(jnp.asarray(x) * jax.nn.silu(jnp.asarray(z)), jnp.asarray(w), eps)
    np.testing.assert_allclose(got.numpy(), _np32(want), atol=GATED_TOL["float32"])


def test_gated_rmsnorm_cpu_is_the_plain_version_and_differentiable():
    x = torch.from_numpy(_normal((6, 64), 38)).requires_grad_()
    z = torch.from_numpy(_normal((6, 64), 39))
    w = torch.from_numpy(_normal((64,), 40))
    reset_launches()
    out = gated_rmsnorm(x, z, w)
    torch.testing.assert_close(out, ref_gated_rmsnorm(x, z, w), rtol=0, atol=0)
    out.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert LAUNCHES["gated_rmsnorm"] == 0


@pytest.mark.parametrize("x,z,w,err", [
    (torch.zeros(4, 8), torch.zeros(4, 7), torch.zeros(8), ValueError),
    (torch.zeros(4, 8), torch.zeros(4, 8), torch.zeros(7), ValueError),
    (torch.zeros(4, 8, dtype=torch.int32), torch.zeros(4, 8), torch.zeros(8), TypeError),
    (torch.zeros(4, 8), torch.zeros(4, 8), torch.zeros(8, dtype=torch.int64), TypeError),
])
def test_gated_rmsnorm_validation(x, z, w, err):
    with pytest.raises(err):
        gated_rmsnorm(x, z, w)


# ----------------------------------------------------------------- SSD scan

@pytest.mark.parametrize("B,H,L,P,N,chunk", [
    (1, 1, 64, 16, 8, 16),
    (2, 3, 128, 32, 16, 32),
    (1, 2, 96, 8, 4, 48),
    (2, 1, 256, 64, 64, 128),    # mamba2-like dims
])
def test_ssd_scan_matches_pallas(B, H, L, P, N, chunk):
    x, a, b, c = _ssd_inputs(B, H, L, P, N, seed=10 + L + P)
    got = ssd_scan(*(torch.from_numpy(t) for t in (x, a, b, c)), chunk=chunk)
    assert got.shape == (B, H, L, P) and got.dtype == torch.float32
    xj, aj, bj, cj = (jnp.asarray(t) for t in (x, a, b, c))
    want = ssd_scan_pallas(xj, aj, bj, cj, chunk=chunk, interpret=True)
    np.testing.assert_allclose(got.numpy(), _np32(want), **SSD_TOL)
    np.testing.assert_allclose(got.numpy(), _np32(jax_ref_ssd(xj, aj, bj, cj)), **SSD_TOL)


def test_ssd_scan_chunk_invariance():
    """The chunk is a schedule, not a result: chunks of 16 and 128 agree,
    on the port's side and with the Pallas kernel at each chunk."""
    x, a, b, c = _ssd_inputs(1, 2, 128, 16, 8, seed=14)
    tt = [torch.from_numpy(t) for t in (x, a, b, c)]
    o16, o128 = ssd_scan(*tt, chunk=16), ssd_scan(*tt, chunk=128)
    np.testing.assert_allclose(o16.numpy(), o128.numpy(), **SSD_CHUNK_TOL)
    jj = [jnp.asarray(t) for t in (x, a, b, c)]
    for chunk, got in ((16, o16), (128, o128)):
        want = ssd_scan_pallas(*jj, chunk=chunk, interpret=True)
        np.testing.assert_allclose(got.numpy(), _np32(want), **SSD_TOL)


@pytest.mark.parametrize("L,chunk", [(100, 32), (7, 4), (5, 16)])
def test_ssd_scan_pads_the_tail_with_identity_steps(L, chunk):
    """L not a multiple of the chunk: the wrapper pads a = 0, b = x = 0,
    which leaves y and the final state as the unpadded recurrence's."""
    x, a, b, c = _ssd_inputs(2, 3, L, 8, 4, seed=20 + L, shared_bc=True)
    tt = [torch.from_numpy(t) for t in (x, a, b, c)]
    got, h = ssd_scan(*tt, chunk=chunk, return_state=True)
    assert got.shape == (2, 3, L, 8) and h.shape == (2, 3, 4, 8)
    jj = [jnp.asarray(t) for t in (x, a, b, c)]
    np.testing.assert_allclose(got.numpy(), _np32(jax_ref_ssd(*jj)), **SSD_TOL)
    _, jh = jax_ssd_chunked(jj[0].transpose(0, 2, 1, 3)[:, :, None],
                            jj[1].transpose(0, 2, 1)[:, :, None], jj[2][:, 0, :, None],
                            jj[3][:, 0, :, None], chunk)
    np.testing.assert_allclose(h.numpy(), _np32(jh[:, 0]), **SSD_TOL)


@pytest.mark.parametrize("B,H,L,P,N,chunk", [(2, 4, 64, 16, 8, 16), (1, 3, 96, 8, 16, 32)])
def test_ssd_scan_final_state_matches_jax_ssd_chunked(B, H, L, P, N, chunk):
    """``return_state`` gives the ``h_fin`` of the JAX package's
    ``ssd_chunked`` for one group shared by the heads (Mamba2's call)."""
    x, a, b, c = _ssd_inputs(B, H, L, P, N, seed=30 + L, shared_bc=True)
    y, h = ssd_scan(*(torch.from_numpy(t) for t in (x, a, b, c)), chunk=chunk,
                    return_state=True)
    assert h.shape == (B, H, N, P) and h.dtype == torch.float32
    jy, jh = jax_ssd_chunked(jnp.asarray(x).transpose(0, 2, 1, 3)[:, :, None],
                             jnp.asarray(a).transpose(0, 2, 1)[:, :, None],
                             jnp.asarray(b)[:, 0, :, None], jnp.asarray(c)[:, 0, :, None], chunk)
    np.testing.assert_allclose(h.numpy(), _np32(jh[:, 0]), **SSD_TOL)
    np.testing.assert_allclose(y.numpy(), _np32(jy[:, :, 0].transpose(0, 2, 1, 3)), **SSD_TOL)


def test_ssd_scan_cpu_is_the_plain_version():
    x, a, b, c = (torch.from_numpy(t) for t in _ssd_inputs(1, 2, 32, 8, 4, seed=40))
    reset_launches()
    y, h = ssd_scan(x, a, b, c, chunk=8, return_state=True)
    want, want_h = ref_ssd(x, a, b, c, return_state=True)
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    torch.testing.assert_close(h, want_h, rtol=0, atol=0)
    assert LAUNCHES["ssd_scan"] == 0


@pytest.mark.parametrize("shapes,err", [
    (((1, 2, 8, 4), (1, 2, 8), (1, 2, 8, 3), (1, 2, 8, 3)), None),
    (((1, 2, 8), (1, 2, 8), (1, 2, 8, 3), (1, 2, 8, 3)), ValueError),
    (((1, 2, 8, 4), (1, 2, 7), (1, 2, 8, 3), (1, 2, 8, 3)), ValueError),
    (((1, 2, 8, 4), (1, 2, 8), (1, 2, 8, 3), (1, 2, 8, 2)), ValueError),
    (((1, 2, 8, 4), (1, 2, 8), (1, 3, 8, 3), (1, 3, 8, 3)), ValueError),
])
def test_ssd_scan_validation(shapes, err):
    x, a, b, c = (torch.zeros(s) for s in shapes)
    if err is None:
        assert ssd_scan(x, a, b, c, chunk=4).shape == x.shape
        with pytest.raises(ValueError):
            ssd_scan(x, a, b, c, chunk=0)
        with pytest.raises(TypeError):
            ssd_scan(x, a, b.to(torch.float64), c, chunk=4)
        with pytest.raises(ValueError, match="path"):
            ssd_scan(x, a, b, c, chunk=4, path="fast")
        return
    with pytest.raises(err):
        ssd_scan(x, a, b, c, chunk=4)


@pytest.mark.parametrize("path", ["auto", "chunks", "seq", "hopper"])
def test_ssd_scan_cpu_takes_the_plain_version_on_every_path(path):
    """``path`` picks among the CUDA kernels; a CPU tensor takes the plain
    version whichever is asked for."""
    x, a, b, c = (torch.from_numpy(t) for t in _ssd_inputs(1, 2, 24, 8, 4, seed=140))
    reset_launches()
    y, h = ssd_scan(x, a, b, c, chunk=8, return_state=True, path=path)
    want, want_h = ref_ssd(x, a, b, c, return_state=True)
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    torch.testing.assert_close(h, want_h, rtol=0, atol=0)
    assert LAUNCHES["ssd_scan"] == 0


def _shared_view(B, H, L, N, dtype=torch.float32):
    """b or c as Mamba2 passes them: one (B, L, N) group as a stride-0 head view."""
    return torch.zeros(B, L, N, dtype=dtype)[:, None].expand(B, H, L, N)


@pytest.mark.parametrize("case,want", [
    ("mamba2", True),              # zamba2-7b's scan: N = P = 64, chunk 256, shared b, c
    ("chunk64", True), ("chunk128", True), ("chunk192", True),
    ("chunk32", False),            # chunks are whole 64-row tiles
    ("chunk320", False),           # up to 256 steps (the scores of a row tile in shared memory)
    ("n32", False), ("p128", False),
    ("bf16", True), ("f16", False),
    ("x_transposed", True),        # the model's (B, L, H, P) memory viewed as (B, H, L, P)
    ("x_rows_off_16_bytes", False),
    ("x_base_off_16_bytes", False),
    ("bc_per_head", True),
    ("bc_stride0_not_shared", False),
    ("bc_projection_slice", True),  # Mamba2's B: a column slice of the conv's output
])
def test_ssd_scan_hopper_route_rule(case, want):
    """``hopper_takes``, the size rule that sends a call to the TMA/wgmma
    route under ``path="auto"``: Mamba2's widths, whole 64-step tiles up to
    256, f32 or bf16, views TMA can read (b and c's head axis left out when
    they are one group)."""
    from repro_torch.kernels.ssd_scan import hopper_takes

    B, H, L, P, N, chunk, shared = 1, 4, 512, 64, 64, 256, True
    dtype = {"bf16": torch.bfloat16, "f16": torch.float16}.get(case, torch.float32)
    if case.startswith("chunk"):
        chunk = int(case[5:])
    N = 32 if case == "n32" else N
    P = 128 if case == "p128" else P
    x = torch.zeros(B, H, L, P, dtype=dtype)
    if case == "x_transposed":
        x = torch.zeros(B, L, H, P).transpose(1, 2)
    elif case == "x_rows_off_16_bytes":
        x = torch.zeros(B, H, L, P + 2)[..., :P]
    elif case == "x_base_off_16_bytes":
        x = torch.zeros(B * H * L * P + 1)[1:].view(B, H, L, P)
    b = c = _shared_view(B, H, L, N, dtype)
    if case == "bc_per_head":
        b = c = torch.zeros(B, H, L, N)
        shared = False
    elif case == "bc_stride0_not_shared":
        shared = False
    elif case == "bc_projection_slice":
        xbc = torch.zeros(B, L, 4 * 64 + 2 * N)
        b = xbc[..., 256:256 + N][:, None].expand(B, H, L, N)
        c = xbc[..., 256 + N:][:, None].expand(B, H, L, N)
    assert hopper_takes(x, b, c, chunk, shared) is want


@pytest.mark.parametrize("dtype,B,H,chunk,want", [
    ("float32", 1, 112, 256, True),       # zamba2-7b's loss
    ("bfloat16", 1, 112, 256, True),
    ("float32", 8, 112, 64, True),        # its serve prefill
    ("bfloat16", 8, 112, 64, True),
    ("float32", 8, 112, 32, False),       # no whole 64-row tile
])
def test_ssd_scan_hopper_rule_at_mamba2_shapes(dtype, B, H, chunk, want):
    """zamba2-7b's scans take the Hopper route in both dtypes, with 16
    heads a block at chunks of 64 and 4 at longer ones; the rule is
    remembered by shapes and strides, the bases' alignment checked each
    call."""
    from repro_torch.kernels.ssd_scan import head_group, hopper_takes

    dt = _TORCH[dtype]
    x = torch.zeros(B, 512, H, 64, dtype=dt).transpose(1, 2)
    bc = _shared_view(B, H, 512, 64, dt)
    assert hopper_takes(x, bc, bc, chunk, True) is want
    assert head_group(chunk) == (16 if chunk <= 64 else 4)
    off = torch.zeros(B * 512 * H * 64 + 1, dtype=dt)[1:].view(B, 512, H, 64).transpose(1, 2)
    assert not hopper_takes(off, bc, bc, chunk, True)


@pytest.mark.parametrize("shape,strides,offset,skip_head,want", [
    ((2, 3, 8, 64), None, 0, False, True),
    ((2, 3, 8, 64), (1536, 64, 192, 1), 0, False, True),      # a transposed (B, L, H, P) view
    ((2, 3, 8, 64), (1536, 0, 64, 1), 0, False, False),       # stride-0 heads
    ((2, 3, 8, 64), (1536, 0, 64, 1), 0, True, True),         # ... left out of the map
    ((2, 3, 8, 6), None, 0, False, False),                    # 24-byte rows
    ((2, 3, 8, 64), None, 2, False, False),                   # base off 16 bytes
    ((1, 1, 8, 64), (7, 5, 64, 1), 0, False, True),           # axes of length 1 never move
    ((2, 3, 8, 64), (1536, 512, 64, 2), 0, False, False),     # the last axis strided
])
def test_ssd_scan_tma_readable(shape, strides, offset, skip_head, want):
    """What a TMA tensor map of the Hopper route reads in place: the last
    axis contiguous, the base on 16 bytes, every other axis longer than 1 a
    nonzero multiple of 16 bytes (the head axis left out for b and c shared
    by the heads). Held through ``hopper_takes`` with x as the view."""
    from repro_torch.kernels.ssd_scan import hopper_takes

    base = torch.zeros(4096 + offset)
    x = (base[offset:offset + int(np.prod(shape))].view(shape) if strides is None
         else base.as_strided(shape, strides, offset))
    if skip_head:                       # the view as b and c, one group over the heads
        ok = torch.zeros(2, 3, 8, 64)
        assert hopper_takes(ok, x, x, 64, True) is want
        return
    bc = _shared_view(shape[0], shape[1], shape[2], 64)
    assert hopper_takes(x, bc, bc, 64, True) is (want and shape[-1] == 64)


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels cannot run on the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(1, 7168), (300, 7168), (257, 128), (33, 96), (5, 100),
                                    (3, 9000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_rmsnorm_cuda_matches_plain(cuda_device, rows, d, dtype):
    x = _to_torch(_normal((rows, d), 80), dtype).to(cuda_device)
    z = _to_torch(_normal((rows, d), 81), dtype).to(cuda_device)
    w = _to_torch(_normal((d,), 82, scale=0.1, shift=1.0), dtype).to(cuda_device)
    reset_launches()
    got, want = gated_rmsnorm(x, z, w), ref_gated_rmsnorm(x, z, w)
    torch.cuda.synchronize()
    assert LAUNCHES["gated_rmsnorm"] == 1
    assert got.dtype == _TORCH[dtype] and got.shape == (rows, d)
    assert (got.float() - want.float()).abs().max().item() <= GATED_TOL[dtype]


@pytest.mark.cuda
def test_gated_rmsnorm_cuda_reads_strided_rows(cuda_device):
    """Mamba2's z is a column slice of its input projection: rows strided."""
    proj = torch.from_numpy(_normal((2, 64, 3 * 256 + 8), 83)).to(cuda_device)
    y = torch.from_numpy(_normal((2, 64, 256), 84)).to(cuda_device)
    z = proj[..., 8:8 + 256]
    w = torch.from_numpy(_normal((256,), 85)).to(cuda_device)
    got, want = gated_rmsnorm(y, z, w), ref_gated_rmsnorm(y, z, w)
    assert got.is_contiguous() and (got - want).abs().max().item() <= GATED_TOL["float32"]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L,P,N,chunk", [
    (1, 1, 64, 16, 8, 16), (2, 3, 128, 32, 16, 32), (1, 2, 96, 8, 4, 48),
    (2, 1, 256, 64, 64, 128), (1, 4, 512, 64, 64, 256), (2, 2, 100, 16, 16, 32),
    (1, 3, 40, 12, 6, 10),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_cuda_matches_plain(cuda_device, B, H, L, P, N, chunk, dtype):
    x, a, b, c = _ssd_inputs(B, H, L, P, N, seed=90 + L)
    xt, bt, ct = (_to_torch(t, dtype).to(cuda_device) for t in (x, b, c))
    at = torch.from_numpy(a).to(cuda_device)
    reset_launches()
    got, h = ssd_scan(xt, at, bt, ct, chunk=chunk, return_state=True)
    want, want_h = ref_ssd(xt, at, bt, ct, return_state=True)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == 1
    assert got.dtype == _TORCH[dtype] and got.shape == (B, H, L, P)
    # bf16: y is rounded to bf16 after the same f32 arithmetic
    tol = SSD_TOL if dtype == "float32" else dict(atol=5e-2, rtol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(h, want_h, **SSD_TOL)


@pytest.mark.cuda
def test_ssd_scan_cuda_reads_mamba2_views(cuda_device):
    """Mamba2's call: x a transposed (B, L, H, P) view, B and C one
    (B, L, N) group as stride-0 head views; y takes x's layout."""
    B, L, H, P, N = 2, 128, 6, 16, 8
    xm = torch.from_numpy(_normal((B, L, H, P), 95, 0.5)).to(cuda_device)
    am = -torch.nn.functional.softplus(torch.from_numpy(_normal((B, L, H), 96))).to(cuda_device)
    bm, cm = (torch.from_numpy(_normal((B, L, N), s, 0.3)).to(cuda_device) for s in (97, 98))
    args = (xm.transpose(1, 2), am.transpose(1, 2), bm[:, None].expand(B, H, L, N),
            cm[:, None].expand(B, H, L, N))
    got = ssd_scan(*args, chunk=32)
    want = ref_ssd(*(t.contiguous() for t in args))
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got, want, **SSD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_cuda_head_dim_112(cuda_device, causal, dtype):
    """zamba2-7b's shared attention: 32 heads of 3584 / 32 = 112."""
    q, k, v = (_to_torch(_normal((1, 4, 256, 112), 100 + i), dtype).to(cuda_device)
               for i in range(3))
    reset_launches()
    got, want = flash_attention(q, k, v, causal=causal), ref_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.cuda
def test_cuda_ssm_kernels_refuse_autograd(cuda_device):
    x = torch.ones(4, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        gated_rmsnorm(x, x.detach(), torch.ones(64, device=cuda_device))
    xs = torch.ones(1, 2, 16, 8, device=cuda_device, requires_grad=True)
    a = torch.zeros(1, 2, 16, device=cuda_device)
    bc = torch.ones(1, 2, 16, 4, device=cuda_device)
    with pytest.raises(NotImplementedError, match="item 12"):
        ssd_scan(xs, a, bc, bc, chunk=8)
    with torch.no_grad():
        assert gated_rmsnorm(x, x, torch.ones(64, device=cuda_device)).shape == x.shape
        assert ssd_scan(xs, a, bc, bc, chunk=8).shape == xs.shape


@pytest.mark.cuda
def test_ssd_scan_cuda_refuses_a_chunk_too_large_for_shared_memory(cuda_device):
    """A block keeps its chunk's cumsum of a in shared memory beside its
    tiles: at N = P = 64 a chunk of 65536 steps needs more than a block
    has, so the launch is refused and the wrapper raises, naming the size."""
    L = 65536
    x = torch.zeros(1, 1, L, 64, device=cuda_device)
    bc = torch.zeros(1, 1, L, 64, device=cuda_device)
    with pytest.raises(RuntimeError, match="shared memory"):
        ssd_scan(x, torch.zeros(1, 1, L, device=cuda_device), bc, bc, chunk=L)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L,P,N,chunk", [
    (1, 2, 60, 12, 6, 20),      # N, P and the chunk no multiples of the mma tile
    (2, 3, 90, 20, 10, 30),
    (1, 2, 9, 8, 4, 1),         # a chunk of 1
    (1, 2, 7, 8, 4, 16),        # L < chunk
    (1, 2, 512, 16, 8, 16),     # 32 chunks: the state pass walks them in order
    (2, 3, 640, 8, 6, 16),      # 40 chunks
    (1, 2, 200, 100, 16, 72),   # P = 100 pads to the 128-wide tile; 3 row tiles of 64
    (1, 1, 256, 128, 72, 256),  # P = 128, N = 72: two blocks of state rows
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_cuda_tile_edges(cuda_device, B, H, L, P, N, chunk, dtype):
    """The chunk-parallel kernel's tile edges, with B and C one group read
    as stride-0 head views, y and the final state against ``ref_ssd``."""
    x, a, b, c = _ssd_inputs(B, H, L, P, N, seed=110 + L + P, shared_bc=True)
    xt = _to_torch(x, dtype).to(cuda_device)
    bt, ct = (_to_torch(np.ascontiguousarray(t[:, :1]), dtype).to(cuda_device)
              .expand(B, H, L, N) for t in (b, c))
    at = torch.from_numpy(a).to(cuda_device)
    reset_launches()
    got, h = ssd_scan(xt, at, bt, ct, chunk=chunk, return_state=True)
    want, want_h = ref_ssd(xt, at, bt.contiguous(), ct.contiguous(), return_state=True)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == 1
    assert got.dtype == _TORCH[dtype] and got.shape == (B, H, L, P) and h.shape == (B, H, N, P)
    tol = SSD_TOL if dtype == "float32" else dict(atol=5e-2, rtol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(h, want_h, **SSD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L,P,N,chunk", [
    (3, 100, 128, 64, 64, 64),  # the serve prefill's chunk and widths
    (4, 70, 100, 12, 6, 32),    # ragged L, N and P
    (2, 140, 40, 8, 4, 1),      # a chunk of 1: 40 chunks
    (2, 150, 20, 16, 72, 64),   # N past 64: the four-launch path
])
@pytest.mark.parametrize("shared_bc", [True, False])
def test_ssd_scan_cuda_many_heads(cuda_device, B, H, L, P, N, chunk, shared_bc):
    """At least two (batch, head) pairs per SM, B and C per head or one
    shared group: two device launches beside the tail's padding, as a CUDA
    graph of the call counts them: Mamba2's widths (N = P = 64, a whole
    64-step chunk) take the Hopper route's two kernels, other chunks and
    states of at most 64 the kernel that walks each pair's chunks in one
    block (the state kept in shared memory); the chunk-parallel mma.sync
    kernels (four launches) agree when forced."""
    from repro_torch.kernels import device_launches
    from repro_torch.kernels.ssd_scan import _pad_seq

    assert B * H >= 2 * torch.cuda.get_device_properties(cuda_device).multi_processor_count
    x, a, b, c = _ssd_inputs(B, H, L, P, N, seed=130 + L + N, shared_bc=shared_bc)
    xt, at = (torch.from_numpy(t).to(cuda_device) for t in (x, a))
    if shared_bc:
        bt, ct = (torch.from_numpy(np.ascontiguousarray(t[:, :1])).to(cuda_device)
                  .expand(B, H, L, N) for t in (b, c))
    else:
        bt, ct = (torch.from_numpy(t).to(cuda_device) for t in (b, c))
    got, h = ssd_scan(xt, at, bt, ct, chunk=chunk, return_state=True)
    want, want_h = ref_ssd(xt, at, bt.contiguous(), ct.contiguous(), return_state=True)
    torch.testing.assert_close(got, want, **SSD_TOL)
    torch.testing.assert_close(h, want_h, **SSD_TOL)
    Q = min(chunk, L)
    Lp = -(-L // Q) * Q
    padding = device_launches(lambda: [_pad_seq(t, Lp) for t in (xt, at, bt, ct)]) \
        if Lp != L else 0
    assert device_launches(lambda: ssd_scan(xt, at, bt, ct, chunk=chunk)) \
        == padding + (2 if N <= 64 else 4)
    got_c, h_c = ssd_scan(xt, at, bt, ct, chunk=chunk, return_state=True, path="chunks")
    torch.testing.assert_close(got_c, want, **SSD_TOL)
    torch.testing.assert_close(h_c, want_h, **SSD_TOL)
    assert device_launches(lambda: ssd_scan(xt, at, bt, ct, chunk=chunk, path="chunks")) \
        == padding + 4


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L,P,N,chunk", [
    (1, 2, 60, 12, 6, 20),      # N, P and the chunk no multiples of the mma tile
    (1, 2, 9, 8, 4, 1),         # a chunk of 1
    (1, 2, 7, 8, 4, 16),        # L < chunk
    (2, 3, 640, 8, 6, 16),      # 40 chunks
    (1, 2, 256, 100, 64, 64),   # P = 100 pads to the 128-wide tile; the widest chunk and N
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_cuda_sequential_path_tile_edges(cuda_device, B, H, L, P, N, chunk, dtype):
    """The kernel that walks each (batch, head)'s chunks, forced at few
    pairs, at its tile edges; it refuses chunks or states wider than 64."""
    x, a, b, c = _ssd_inputs(B, H, L, P, N, seed=150 + L + P, shared_bc=True)
    xt = _to_torch(x, dtype).to(cuda_device)
    bt, ct = (_to_torch(np.ascontiguousarray(t[:, :1]), dtype).to(cuda_device)
              .expand(B, H, L, N) for t in (b, c))
    at = torch.from_numpy(a).to(cuda_device)
    got, h = ssd_scan(xt, at, bt, ct, chunk=chunk, return_state=True, path="seq")
    want, want_h = ref_ssd(xt, at, bt.contiguous(), ct.contiguous(), return_state=True)
    tol = SSD_TOL if dtype == "float32" else dict(atol=5e-2, rtol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(h, want_h, **SSD_TOL)
    zx, zbc = (torch.zeros(1, 1, 128, w, device=cuda_device) for w in (8, 4))
    with pytest.raises(RuntimeError, match="launch failed"):
        ssd_scan(zx, torch.zeros(1, 1, 128, device=cuda_device), zbc, zbc, chunk=128,
                 path="seq")


def _hopper_kernels(fn) -> list:
    """The device kernels one call enqueues, by name."""
    from repro_torch.kernels import graph_kernels

    return graph_kernels(fn)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L,chunk,shared,head_group", [
    (1, 112, 256, 256, True, 8),     # one chunk (Z = 1) of zamba2's loss chunk, all 112 heads
    (1, 112, 512, 128, True, 6),     # a head group that does not divide 112 (19 groups, last of 4)
    (2, 112, 256, 64, True, 16),     # the serve prefill's chunk
    (1, 3, 384, 192, True, 8),       # 192-step chunks; a group wider than H
    (2, 5, 1024, 64, True, 3),       # 16 chunks: the pass over the chunks walks them in order
    (1, 6, 512, 256, False, 8),      # b and c per head: a head a block
    (2, 4, 256, 128, False, 8),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_cuda_hopper_route(cuda_device, monkeypatch, B, H, L, chunk, shared,
                                    head_group, dtype):
    """The TMA/wgmma route forced through ``path``, y and the final state
    against ``ref_ssd``, with b and c one group (stride-0 head views) or
    per head; ``head_group`` heads a block share the chunk's scores."""
    mod = sys.modules["repro_torch.kernels.ssd_scan"]

    monkeypatch.setattr(mod, "head_group", lambda chunk: head_group)
    P = N = 64
    x, a, b, c = _ssd_inputs(B, H, L, P, N, seed=170 + L + H, shared_bc=shared)
    xt = _to_torch(x, dtype).to(cuda_device)
    if shared:
        bt, ct = (_to_torch(np.ascontiguousarray(t[:, :1]), dtype).to(cuda_device)
                  .expand(B, H, L, N) for t in (b, c))
    else:
        bt, ct = (_to_torch(t, dtype).to(cuda_device) for t in (b, c))
    at = torch.from_numpy(a).to(cuda_device)
    reset_launches()
    got, h = ssd_scan(xt, at, bt, ct, chunk=chunk, return_state=True, path="hopper")
    want, want_h = ref_ssd(xt, at, bt.contiguous(), ct.contiguous(), return_state=True)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == 1
    assert got.dtype == _TORCH[dtype] and got.shape == (B, H, L, P) and h.shape == (B, H, N, P)
    tol = SSD_TOL if dtype == "float32" else dict(atol=5e-2, rtol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(h, want_h, **SSD_TOL)
    assert torch.equal(ssd_scan(xt, at, bt, ct, chunk=chunk, path="auto"), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_cuda_hopper_reads_mamba2_views(cuda_device, dtype):
    """Mamba2's call as the model makes it: x a transposed (B, L, H, P)
    view, B and C column slices of the conv's output (B, L, 2 d + 2 N)
    viewed over the heads with stride 0. ``auto`` takes the Hopper route
    (two device kernels, no copy of any input), y takes x's layout."""
    B, L, H, P, N, chunk = 2, 512, 6, 64, 64, 256
    dt = _TORCH[dtype]
    xm = _to_torch(_normal((B, L, H, P), 180, 0.5), dtype).to(cuda_device)
    am = -torch.nn.functional.softplus(torch.from_numpy(_normal((B, L, H), 181))).to(cuda_device)
    xbc = _to_torch(_normal((B, L, H * P + 2 * N), 182, 0.3), dtype).to(cuda_device)
    bm, cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    args = (xm.transpose(1, 2), am.transpose(1, 2), bm[:, None].expand(B, H, L, N),
            cm[:, None].expand(B, H, L, N))
    got, h = ssd_scan(*args, chunk=chunk, return_state=True)
    want, want_h = ref_ssd(*(t.contiguous() for t in args), return_state=True)
    assert got.dtype == dt and got.transpose(1, 2).is_contiguous()
    tol = SSD_TOL if dtype == "float32" else dict(atol=5e-2, rtol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(h, want_h, **SSD_TOL)
    names = _hopper_kernels(lambda: ssd_scan(*args, chunk=chunk, return_state=True))
    assert len(names) == 2 and all("tma" in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_cuda_every_route_agrees(cuda_device, dtype):
    """At a Mamba2 shape every route forced through ``path`` agrees with
    ``ref_ssd``: ``auto`` and ``hopper`` (two device kernels), ``chunks``
    (four) and ``seq`` (two)."""
    B, H, L, P, N, chunk = 2, 8, 256, 64, 64, 64
    x, a, b, c = _ssd_inputs(B, H, L, P, N, seed=190, shared_bc=True)
    xt = _to_torch(x, dtype).to(cuda_device)
    bt, ct = (_to_torch(np.ascontiguousarray(t[:, :1]), dtype).to(cuda_device)
              .expand(B, H, L, N) for t in (b, c))
    at = torch.from_numpy(a).to(cuda_device)
    want, want_h = ref_ssd(xt, at, bt.contiguous(), ct.contiguous(), return_state=True)
    tol = SSD_TOL if dtype == "float32" else dict(atol=5e-2, rtol=1e-2)
    kernels = {}
    for path in ("auto", "hopper", "chunks", "seq"):
        got, h = ssd_scan(xt, at, bt, ct, chunk=chunk, return_state=True, path=path)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        torch.testing.assert_close(h, want_h, **SSD_TOL)
        kernels[path] = _hopper_kernels(
            lambda: ssd_scan(xt, at, bt, ct, chunk=chunk, return_state=True, path=path))
    assert kernels["auto"] == kernels["hopper"] and len(kernels["hopper"]) == 2
    assert len(kernels["chunks"]) == 4 and len(kernels["seq"]) == 2
    assert not any("tma" in n for n in kernels["chunks"] + kernels["seq"])


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,L,P,N,chunk", [
    (1, 2, 256, 64, 32, 64),     # N off Mamba2's 64
    (1, 2, 256, 32, 64, 64),     # P off 64
    (1, 2, 256, 64, 64, 32),     # a chunk that is no whole 64-row tile
])
def test_ssd_scan_cuda_hopper_refuses_other_shapes(cuda_device, B, H, L, P, N, chunk):
    """Forced onto the Hopper route, a shape it does not take is refused
    at launch and the wrapper raises; ``auto`` sends it to the mma.sync
    kernels."""
    x = torch.zeros(B, H, L, P, device=cuda_device)
    bc = torch.zeros(B, H, L, N, device=cuda_device)
    a = torch.zeros(B, H, L, device=cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        ssd_scan(x, a, bc, bc, chunk=chunk, path="hopper")
    assert not any("tma" in n for n in _hopper_kernels(lambda: ssd_scan(x, a, bc, bc,
                                                                           chunk=chunk)))


@pytest.mark.cuda
def test_ssd_scan_sass_holds_wgmma_and_tma(cuda_device):
    """The library's Hopper kernels compiled to wgmma (HGMMA) and TMA loads
    (UTMALDG), and issue no mma.sync (HMMA); the mma.sync route's kernels
    are the library's only HMMA."""
    from repro_torch.kernels.build import sass

    code = sass("ssd_scan")
    funcs = {f.split("\n", 1)[0]: f for f in code.split("Function : ")[1:]}
    hopper = {name: f for name, f in funcs.items() if "_tma" in name}
    assert len(hopper) == 4, sorted(funcs)          # two kernels in two dtypes
    for name, f in hopper.items():
        assert "HGMMA" in f and "UTMALDG" in f and "HMMA" not in f, name


@pytest.mark.cuda
def test_ssd_scan_cuda_chunk_invariance_over_many_chunks(cuda_device):
    """64 chunks of 16 against 16 chunks of 64 at Mamba2's N = P = 64."""
    x, a, b, c = (torch.from_numpy(t).to(cuda_device)
                  for t in _ssd_inputs(1, 2, 1024, 64, 64, seed=120))
    y16, h16 = ssd_scan(x, a, b, c, chunk=16, return_state=True)
    y64, h64 = ssd_scan(x, a, b, c, chunk=64, return_state=True)
    torch.testing.assert_close(y16, y64, **SSD_CHUNK_TOL)
    torch.testing.assert_close(h16, h64, **SSD_CHUNK_TOL)
