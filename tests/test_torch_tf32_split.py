"""The three-pass TF32 split that the CUDA flash attention and SSD scan use
for f32 products, emulated on the CPU.

The kernels multiply on the tensor cores in TF32 (10 mantissa bits). For
an f32 operand x they take ``big = tf32(x)`` (round to nearest, ties away
from zero, as ``cvt.rna.tf32.f32``) and ``small = x - big``, whose low 13
bits the TF32 product drops, and sum ``a_small b_big + a_big b_small +
a_big b_big`` in f32. A product of two
TF32 values is exact in f32, so the emulation rounds the operands and
multiplies in f32. These tests show that the split holds the kernels' f32
gates (attention atol 2e-5, the SSD scan atol 5e-4 / rtol 1e-3, as
tests/test_kernels.py) where a single TF32 pass does not, and that a bf16
input splits with ``small == 0``: it is exact in TF32, so its products
with other inputs need one pass.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import ref_attention, ref_ssd

ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SSD_TOL = dict(atol=5e-4, rtol=1e-3)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (ties away from zero), kept in f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """f32 -> its top 19 bits (a TF32 operand handed over as f32 bits)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    """The kernels' split: big = tf32(x); small = x - big, read as TF32 by
    the product (its low 13 bits dropped)."""
    big = tf32(x)
    return big, tf32_trunc(x - big)


def mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b in f32 from TF32 operands: one pass (big . big) or the three."""
    ab, as_ = split(a)
    bb, bs = split(b)
    if passes == 1:
        return ab @ bb
    return as_ @ bb + ab @ bs + ab @ bb


def _normal(shape, seed, scale=1.0):
    return torch.from_numpy((scale * np.random.default_rng(seed).standard_normal(shape))
                            .astype(np.float32))


def test_tf32_rounds_to_ten_mantissa_bits_ties_away():
    one = torch.tensor([1.0, -1.0])
    ulp = 2.0 ** -10
    x = torch.cat([one * (1 + ulp / 2), one * (1 + ulp / 2 - 2 ** -20), one * (1 + ulp / 4)])
    torch.testing.assert_close(tf32(x), torch.tensor([1 + ulp, -1 - ulp, 1.0, -1.0, 1.0, -1.0]),
                               rtol=0, atol=0)
    v = _normal((1000,), 1)
    big, small = split(v)
    assert torch.equal(tf32(big), big) and torch.equal(tf32(small), small)
    assert ((v - big).abs() <= v.abs() * 2.0 ** -11).all()
    assert ((v - big - small).abs() <= v.abs() * 2.0 ** -21).all()


def _attention(q, k, v, passes):
    """Causal attention with both products from TF32 operands; softmax and
    sums in f32, P rounded to v's dtype as the kernels do."""
    hd = q.shape[-1]
    s = mm(q.float(), k.float().transpose(-1, -2), passes) * hd ** -0.5
    S = s.shape[-1]
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    return mm(p, v.float(), passes).to(q.dtype)


@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_pass_attention_holds_the_gate(hd, dtype):
    dt = getattr(torch, dtype)
    q, k, v = (_normal((1, 2, 512, hd), 10 + i).to(dt) for i in range(3))
    want = ref_attention(q, k, v, causal=True).float()
    err3 = (_attention(q, k, v, 3).float() - want).abs().max().item()
    assert err3 <= ATTN_TOL[dtype]
    err1 = (_attention(q, k, v, 1).float() - want).abs().max().item()
    if dtype == "float32":
        assert err1 > ATTN_TOL[dtype], f"one TF32 pass unexpectedly held the gate: {err1}"
    else:
        # bf16 q, k, v and P are exact in TF32: one pass is the same product
        big, small = split(q.float())
        assert torch.equal(big, q.float()) and not small.any()
        assert err1 == err3


def _ssd_chunk(x, a, b, c, passes, exact_inputs):
    """One chunk from a zero state, as the CUDA scan computes it:
    y = ((C B^T) o tril(exp(acs_i - acs_j))) X and the state
    sum_j exp(acs[-1] - acs_j) B_j^T X_j. With ``exact_inputs`` (bf16) a
    product of two inputs takes one pass."""
    xf, bf, cf = x.float(), b.float(), c.float()
    acs = torch.cumsum(a, dim=-1)
    seg = acs[..., :, None] - acs[..., None, :]
    Q = x.shape[-2]
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    scores = mm(cf, bf.transpose(-1, -2), 1 if exact_inputs else passes)
    scores = torch.where(causal, scores * torch.exp(torch.where(causal, seg, 0.0)), 0.0)
    y = mm(scores, xf, passes)
    dec = torch.exp(acs[..., -1:] - acs)
    state = mm(bf.transpose(-1, -2), xf * dec[..., None], passes)
    return y.to(x.dtype), state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_pass_ssd_chunk_holds_the_gate(dtype):
    """One chunk of 256 at Mamba2's N = P = 64, inputs as the JAX sweep's."""
    dt = getattr(torch, dtype)
    B, H, L, P, N = 1, 2, 256, 64, 64
    x = _normal((B, H, L, P), 20, 0.5).to(dt)
    a = -torch.nn.functional.softplus(_normal((B, H, L), 21))
    b, c = (_normal((B, H, L, N), s, 0.3).to(dt) for s in (22, 23))
    want_y, want_h = ref_ssd(x, a, b, c, return_state=True)
    y, h = _ssd_chunk(x, a, b, c, 3, dtype == "bfloat16")
    tol = SSD_TOL if dtype == "float32" else dict(atol=5e-2, rtol=1e-2)
    torch.testing.assert_close(y.float(), want_y.float(), **tol)
    torch.testing.assert_close(h, want_h, **SSD_TOL)
    if dtype == "float32":
        y1, _ = _ssd_chunk(x, a, b, c, 1, False)
        diff = (y1 - want_y).abs()
        assert not bool((diff <= SSD_TOL["atol"] + SSD_TOL["rtol"] * want_y.abs()).all()), \
            f"one TF32 pass unexpectedly held the gate: max |err| {diff.max().item()}"
    else:
        # bf16 inputs split with small == 0: C B^T in one pass is the full product
        y3, h3 = _ssd_chunk(x, a, b, c, 3, False)
        assert torch.equal(y, y3) and torch.equal(h, h3)
