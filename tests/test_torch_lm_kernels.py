"""The port's flash attention and RMSNorm against the Pallas kernels they replace.

On the CPU each wrapper takes its plain version; it is held against the
Pallas kernel in interpret mode (``flash_attention_pallas``,
``rmsnorm_pallas``) and against the JAX package's ``ref_attention`` /
``ref_rmsnorm`` on the same numpy inputs, at the gates of
tests/test_kernels.py (attention atol 2e-5 f32 / 3e-2 bf16, RMSNorm 1e-5
f32 / 5e-2 bf16). The CUDA kernels run only on a card (marker ``cuda``),
where they are held against the same plain versions:

    python -m pytest -q -m cuda tests/test_torch_lm_kernels.py tests/test_torch_lm.py
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ref import ref_attention as jax_ref_attention
from repro.kernels.ref import ref_rmsnorm as jax_ref_rmsnorm
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro.models.layers import rms_norm as jax_rms_norm
from repro_torch.kernels import (LAUNCHES, device_launches, flash_attention, reset_launches,
                                 rmsnorm)
from repro_torch.kernels.build import sass
from repro_torch.kernels.flash_attention import HEAD_DIMS, rows_aligned
from repro_torch.kernels.ref import ref_attention, ref_rmsnorm
from repro_torch.models.layers import rms_norm

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# f16: one f16 ulp of an output below 16 (a sum taken in another order can
# round to the next one), as the kernel and the plain version both round
NORM_TOL = {"float32": 1e-5, "bfloat16": 5e-2, "float16": 1e-2}


def _normal(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def _to_torch(a, dtype):
    """numpy f32 -> torch ``dtype``, rounding exactly as JAX's astype."""
    if dtype == "bfloat16":
        bits = a.astype(ml_dtypes.bfloat16).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    if dtype == "float16":
        return torch.from_numpy(a.astype(np.float16))
    return torch.from_numpy(a)


def _np32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


# ----------------------------------------------------------- flash attention

@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,blk", [
    (1, 2, 2, 128, 128, 64, 64),
    (2, 4, 2, 256, 256, 64, 128),   # GQA 2:1
    (1, 8, 2, 128, 128, 32, 64),    # GQA 4:1
    (2, 3, 1, 192, 192, 16, 64),    # odd head count, MQA
    (1, 9, 3, 128, 128, 64, 64),    # smollm's heads: H/KV = 3
    (1, 4, 2, 64, 192, 32, 64),     # Sq < Sk: causal is top-left aligned
    (1, 2, 1, 192, 64, 16, 64),     # Sq > Sk
    (1, 2, 2, 128, 128, 96, 64),    # phi-3-vision's head dim
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas(B, H, KV, Sq, Sk, hd, blk, causal):
    seed = B * 1000 + H * 100 + Sq + Sk + hd
    q, k, v = (_normal(s, seed + i) for i, s in
               enumerate([(B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd)]))
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    assert got.shape == (B, H, Sq, hd) and got.dtype == torch.float32
    qj, kj, vj = (jnp.asarray(a) for a in (q, k, v))
    want = flash_attention_pallas(qj, kj, vj, causal=causal, blk_q=blk, blk_k=blk,
                                  interpret=True)
    np.testing.assert_allclose(got.numpy(), _np32(want), atol=ATTN_TOL["float32"])
    np.testing.assert_allclose(got.numpy(), _np32(jax_ref_attention(qj, kj, vj, causal=causal)),
                               atol=ATTN_TOL["float32"])


@pytest.mark.parametrize("B,H,KV,S,hd", [(1, 2, 2, 128, 64), (1, 9, 3, 128, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_matches_pallas(B, H, KV, S, hd, causal):
    q, k, v = (_normal(s, 40 + i) for i, s in
               enumerate([(B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd)]))
    got = flash_attention(*(_to_torch(a, "bfloat16") for a in (q, k, v)), causal=causal)
    assert got.dtype == torch.bfloat16
    qj, kj, vj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = flash_attention_pallas(qj, kj, vj, causal=causal, interpret=True)
    np.testing.assert_allclose(_np32(got), _np32(want), atol=ATTN_TOL["bfloat16"])
    np.testing.assert_allclose(_np32(got), _np32(jax_ref_attention(qj, kj, vj, causal=causal)),
                               atol=ATTN_TOL["bfloat16"])


def test_flash_attention_cpu_is_the_plain_version():
    q, k, v = (torch.from_numpy(_normal(s, 50 + i)) for i, s in
               enumerate([(2, 4, 64, 32), (2, 2, 64, 32), (2, 2, 64, 32)]))
    reset_launches()
    torch.testing.assert_close(flash_attention(q, k, v), ref_attention(q, k, v), rtol=0, atol=0)
    assert LAUNCHES["flash_attention"] == 0


def test_rows_aligned_refuses_what_a_tensor_map_cannot_read():
    """The wrapper copies a view that a TMA tensor map cannot describe: rows
    that are not contiguous or start off 16 bytes, or on an axis longer than
    1 a stride of 0 or not a multiple of 16 bytes."""
    t = torch.zeros(2, 40, 4, 64)                     # (B, S, H, hd)
    assert rows_aligned(t) and rows_aligned(t.transpose(1, 2))
    assert rows_aligned(t[:, :1]) and rows_aligned(t[:, :1, :1])
    assert rows_aligned(torch.zeros(2, 40, 4, 8, dtype=torch.bfloat16))
    assert not rows_aligned(t[..., 1:])
    assert not rows_aligned(t.transpose(-1, -2))
    assert not rows_aligned(t[:, :1].expand(-1, 40, -1, -1))
    assert not rows_aligned(t[:, :, :1].expand(-1, -1, 4, -1))
    assert not rows_aligned(torch.zeros(2, 40, 4, 63))


@pytest.mark.parametrize("q,k,v,err", [
    (torch.zeros(2, 4, 8), torch.zeros(2, 2, 8, 16), torch.zeros(2, 2, 8, 16), ValueError),
    (torch.zeros(2, 4, 8, 16), torch.zeros(2, 2, 8, 16), torch.zeros(2, 2, 9, 16), ValueError),
    (torch.zeros(2, 4, 8, 16), torch.zeros(2, 3, 8, 16), torch.zeros(2, 3, 8, 16), ValueError),
    (torch.zeros(2, 4, 8, 16), torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8, 16), ValueError),
    (torch.zeros(2, 4, 8, 16), torch.zeros(2, 2, 8, 32), torch.zeros(2, 2, 8, 32), ValueError),
    (torch.zeros(2, 4, 8, 16), torch.zeros(2, 2, 0, 16), torch.zeros(2, 2, 0, 16), ValueError),
    (torch.zeros(2, 4, 8, 16), torch.zeros(2, 2, 8, 16, dtype=torch.bfloat16),
     torch.zeros(2, 2, 8, 16, dtype=torch.bfloat16), TypeError),
    (torch.zeros(2, 4, 8, 16, dtype=torch.int32), torch.zeros(2, 2, 8, 16, dtype=torch.int32),
     torch.zeros(2, 2, 8, 16, dtype=torch.int32), TypeError),
])
def test_flash_attention_validation(q, k, v, err):
    with pytest.raises(err):
        flash_attention(q, k, v)


# ----------------------------------------------------------------- RMSNorm

@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 128), (130, 96), (7, 576)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_pallas(shape, dtype):
    x = _normal(shape, 30)
    w = _normal(shape[-1:], 31, scale=0.1, shift=1.0)
    got = rmsnorm(_to_torch(x, dtype), _to_torch(w, dtype))
    assert got.shape == shape and got.dtype == _TORCH[dtype]
    xj, wj = jnp.asarray(x).astype(_JNP[dtype]), jnp.asarray(w).astype(_JNP[dtype])
    want = rmsnorm_pallas(xj, wj, blk_rows=64, interpret=True)
    np.testing.assert_allclose(_np32(got), _np32(want), atol=NORM_TOL[dtype])
    np.testing.assert_allclose(_np32(got), _np32(jax_ref_rmsnorm(xj, wj)), atol=NORM_TOL[dtype])


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_model_rms_norm_matches_jax_model_rms_norm(eps):
    x, w = _normal((5, 96), 35), _normal((96,), 36)
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w), eps)
    np.testing.assert_allclose(got.numpy(), _np32(jax_rms_norm(jnp.asarray(x), jnp.asarray(w),
                                                               eps)), atol=1e-6)


def test_rmsnorm_cpu_is_the_plain_version_and_differentiable():
    x = torch.from_numpy(_normal((6, 64), 37)).requires_grad_()
    w = torch.from_numpy(_normal((64,), 38))
    reset_launches()
    out = rmsnorm(x, w)
    torch.testing.assert_close(out, ref_rmsnorm(x, w), rtol=0, atol=0)
    out.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert LAUNCHES["rmsnorm"] == 0


@pytest.mark.parametrize("x,w,err", [
    (torch.zeros(4, 8), torch.zeros(7), ValueError),
    (torch.zeros(4, 8), torch.zeros(8, 1), ValueError),
    (torch.zeros(4, 8, dtype=torch.int32), torch.zeros(8), TypeError),
    (torch.zeros(4, 8), torch.zeros(8, dtype=torch.int64), TypeError),
])
def test_rmsnorm_validation(x, w, err):
    with pytest.raises(err):
        rmsnorm(x, w)


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels cannot run on the CPU")
    return torch.device("cuda")


# the loss forwards' shapes (B, H, KV, S, S, hd) at S 2048: smollm-135m at
# B 4 (GQA 3:1), zamba2-7b's shared attention (hd 112), qwen2-moe-a2.7b (hd
# 128) and phi-3-vision-4.2b (hd 96)
FLASH_MODEL_SHAPES = [(4, 9, 3, 2048, 2048, 64), (1, 32, 32, 2048, 2048, 112),
                      (1, 16, 16, 2048, 2048, 128), (1, 32, 32, 2048, 2048, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd", [(2, 9, 3, 256, 256, 64), (1, 16, 8, 128, 128, 128),
                                            (2, 4, 2, 256, 256, 32), (1, 4, 2, 100, 300, 16),
                                            (1, 2, 1, 300, 77, 64)] + FLASH_MODEL_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_cuda_matches_plain(cuda_device, B, H, KV, Sq, Sk, hd, causal, dtype):
    q, k, v = (_to_torch(_normal(s, 60 + i), dtype).to(cuda_device) for i, s in
               enumerate([(B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd)]))
    reset_launches()
    got = flash_attention(q, k, v, causal=causal)
    want = ref_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    assert device_launches(lambda: flash_attention(q, k, v, causal=causal)) == 1
    assert got.dtype == _TORCH[dtype] and got.shape == (B, H, Sq, hd)
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.cuda
def test_flash_attention_cuda_reads_transposed_views(cuda_device):
    """The model hands over (B, S, H, hd) tensors viewed as (B, H, S, hd);
    the output keeps that layout, so transposing it back is contiguous."""
    B, S, H, KV, hd = 2, 256, 9, 3, 64
    q, k, v = (torch.from_numpy(_normal(s, 70 + i)).to(cuda_device) for i, s in
               enumerate([(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)]))
    got = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    want = ref_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert got.transpose(1, 2).is_contiguous()
    assert (got - want).abs().max().item() <= ATTN_TOL["float32"]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd", [FLASH_MODEL_SHAPES[0], FLASH_MODEL_SHAPES[1],
                                            (1, 4, 2, 200, 456, 96)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_cuda_two_calls_are_bit_equal(cuda_device, B, H, KV, Sq, Sk, hd,
                                                      causal, dtype):
    """No atomics and no order that changes between runs: the persistent
    grid gives each block the same items, and every sum runs in a fixed
    order."""
    q, k, v = (_to_torch(_normal(s, 240 + i), dtype).to(cuda_device) for i, s in
               enumerate([(B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd)]))
    assert torch.equal(flash_attention(q, k, v, causal=causal),
                       flash_attention(q, k, v, causal=causal))


@pytest.mark.cuda
def test_flash_attention_library_holds_wgmma_and_tma_loads(cuda_device):
    """The Hopper design compiled to warpgroup products (HGMMA) and TMA
    tensor loads (UTMALDG), and to no warp-level mma.sync (HMMA)."""
    code = sass("flash_attention")
    assert "HGMMA" in code and "UTMALDG" in code
    assert "HMMA" not in code


# (rows, d): the threads a row the launcher picks (the fewest, 8 to 1024,
# whose four 16-byte packs each cover the row) change at d 128, 256, ...,
# 16384 in f32 and twice those in 2-byte types; d 2052 just past a step;
# d 33000 beyond 1024 threads in every dtype and d 100 (bf16, f16) and 1001
# off the 16-byte packs take the two-pass kernel; 8193, 2047, 1025 and 257
# rows leave a block of several rows part full; d 512 is MLA's kv_norm
# (deepseek-v2-lite's latent) at the loss (1 x 2048), the serve prefill
# (8 x 128) and a decode step (8 rows); d 3072 is phi-3-vision's d_model
# at a decode step and the loss
RMSNORM_CUDA_SHAPES = [(1, 576), (8193, 576), (300, 64), (257, 128), (33, 1024), (5, 100),
                       (2047, 2048), (2048, 2052), (1025, 4096), (3, 8192), (2, 16384),
                       (3, 33000), (33, 1001), (2048, 512), (1024, 512), (8, 512),
                       (8, 3072), (2048, 3072)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", RMSNORM_CUDA_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_rmsnorm_cuda_matches_plain(cuda_device, rows, d, dtype):
    x = _to_torch(_normal((rows, d), 80), dtype).to(cuda_device)
    w = _to_torch(_normal((d,), 81, scale=0.1, shift=1.0), dtype).to(cuda_device)
    reset_launches()
    got, want = rmsnorm(x, w), ref_rmsnorm(x, w)
    torch.cuda.synchronize()
    assert LAUNCHES["rmsnorm"] == 1
    assert got.dtype == _TORCH[dtype] and got.shape == (rows, d)
    assert (got.float() - want.float()).abs().max().item() <= NORM_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(8193, 576), (2047, 2048), (1025, 4096), (3, 8192),
                                    (3, 33000), (2048, 512), (1024, 512), (8, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_rmsnorm_cuda_two_calls_are_bit_equal(cuda_device, rows, d, dtype):
    """The sum of squares crosses a row's warps in a fixed order."""
    x = _to_torch(_normal((rows, d), 82), dtype).to(cuda_device)
    w = _to_torch(_normal((d,), 83, scale=0.1, shift=1.0), dtype).to(cuda_device)
    assert torch.equal(rmsnorm(x, w), rmsnorm(x, w))


@pytest.mark.cuda
def test_cuda_kernels_refuse_autograd(cuda_device):
    x = torch.ones(4, 64, device=cuda_device, requires_grad=True)
    w = torch.ones(64, device=cuda_device)
    with pytest.raises(NotImplementedError, match="item 12"):
        rmsnorm(x, w)
    q = torch.ones(1, 2, 64, 64, device=cuda_device, requires_grad=True)
    kv = torch.ones(1, 2, 64, 64, device=cuda_device)
    with pytest.raises(NotImplementedError, match="item 12"):
        flash_attention(q, kv, kv)
    with torch.no_grad():
        assert rmsnorm(x, w).shape == x.shape
        assert flash_attention(q, kv, kv).shape == q.shape


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd", [
    (1, 2, 1, 65, 33, 64),      # Sq, Sk one past the q tile and the f32 kv tile
    (2, 3, 3, 129, 97, 32),     # ragged in both, no GQA
    (1, 2, 2, 257, 130, 128),   # Sq > Sk, neither a multiple of a tile
    (1, 2, 1, 70, 200, 112),    # Sq < Sk at zamba2's head dim
    (1, 4, 2, 1, 77, 64),       # one query row
    (8, 32, 8, 128, 128, 64),   # a large batch of heads
    (1, 2, 1, 1, 1, 96),        # phi-3-vision's head dim: one query, one key
    (1, 2, 2, 63, 63, 96),      # one short of the f32 q tile
    (1, 2, 1, 65, 65, 96),      # one past it
    (2, 3, 3, 129, 129, 96),    # one past the bf16 q tile
    (1, 4, 2, 200, 456, 96),    # Sq < Sk, neither a multiple of a tile
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_cuda_ragged_tiles(cuda_device, B, H, KV, Sq, Sk, hd, causal, dtype):
    q, k, v = (_to_torch(_normal(s, 200 + i), dtype).to(cuda_device) for i, s in
               enumerate([(B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd)]))
    reset_launches()
    got = flash_attention(q, k, v, causal=causal)
    want = ref_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    assert got.dtype == _TORCH[dtype] and got.shape == (B, H, Sq, hd)
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_cuda_every_head_dim(cuda_device, hd, dtype):
    q, k, v = (_to_torch(_normal((2, 4, 160, hd), 210 + i), dtype).to(cuda_device)
               for i in range(3))
    got = flash_attention(q, k, v, causal=True)
    want = ref_attention(q, k, v, causal=True)
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_cuda_reads_transposed_and_unaligned_views(cuda_device, dtype):
    """(B, S, H, hd) views at zamba2's head dim, read in place; then views
    whose rows start one element past 16 bytes, which the wrapper copies."""
    B, S, H, KV, hd = 2, 200, 4, 2, 112
    q, k, v = (_to_torch(_normal(s, 220 + i), dtype).to(cuda_device) for i, s in
               enumerate([(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)]))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    got = flash_attention(*views)
    assert got.transpose(1, 2).is_contiguous()
    assert (got.float() - ref_attention(*views).float()).abs().max().item() \
        <= ATTN_TOL[dtype]
    shifted = [torch.cat([t, t[..., :1]], dim=-1)[..., 1:].transpose(1, 2) for t in (q, k, v)]
    want = ref_attention(*(t.contiguous() for t in shifted))
    assert (flash_attention(*shifted).float() - want.float()).abs().max().item() \
        <= ATTN_TOL[dtype]
    # k and v broadcast along S and along the heads (stride 0), which TMA
    # cannot read, so the wrapper copies them
    for expand in (lambda t: t[:, :, :1].expand(-1, -1, S, -1),
                   lambda t: t[:, :1].expand(-1, KV, -1, -1)):
        kx, vx = expand(k.transpose(1, 2)), expand(v.transpose(1, 2))
        want = ref_attention(views[0], kx.contiguous(), vx.contiguous())
        assert (flash_attention(views[0], kx, vx).float() - want.float()).abs().max().item() \
            <= ATTN_TOL[dtype]
