"""The three-part bf16 split that the CUDA SSD scan's Hopper route uses for
products of a bf16 input with an f32 factor, emulated on the CPU.

With bf16 x, b and c the scan's products either multiply two inputs (the
scores C B^T: exact in one bf16 pass, summed in f32) or an input with an
f32 factor (X^T scaled by the chunk's decays, the decayed scores S o L,
the state h entering a chunk). For the latter the kernel writes the factor
as three bf16 parts, ``hi = bf16(v)``, ``mid = bf16(v - hi)``, ``lo =
bf16(v - hi - mid)`` (round to nearest even each), and sums the three
products with the exact bf16 input in f32: 24 bits of the factor's
mantissa, so the product keeps f32 accuracy at the bf16 rate. These tests
bound the split's error against f64, show that the product holds the f32
state gate where the top part alone does not, and hold one chunk of the
scan computed that way against ``ref_ssd``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import ref_ssd

SSD_TOL = dict(atol=5e-4, rtol=1e-3)
SSD_BF16_TOL = dict(atol=5e-2, rtol=1e-2)


def parts(v: torch.Tensor):
    """f32 v -> its three bf16 parts, each kept in f32 (exact)."""
    hi = v.to(torch.bfloat16).float()
    r = v - hi
    mid = r.to(torch.bfloat16).float()
    lo = (r - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def mm3(x: torch.Tensor, f: torch.Tensor, n_parts: int = 3, factor_left: bool = False):
    """x @ f (or f @ x) for a bf16-exact x and an f32 factor f, as the
    kernel sums it: one product per bf16 part of f, in f32. Each product of
    two bf16 values is exact in f32."""
    out = 0
    for p in parts(f)[:n_parts]:
        out = out + (p @ x if factor_left else x @ p)
    return out


def _normal(shape, seed, scale=1.0):
    return torch.from_numpy((scale * np.random.default_rng(seed).standard_normal(shape))
                            .astype(np.float32))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_three_parts_keep_24_bits(scale):
    v = _normal((4096,), 1, scale)
    hi, mid, lo = parts(v)
    for p in (hi, mid, lo):
        assert torch.equal(p.to(torch.bfloat16).float(), p)   # each part is a bf16 value
    err = (v.double() - (hi.double() + mid.double() + lo.double())).abs()
    assert (err <= v.abs().double() * 2.0 ** -24).all()
    # the top part alone keeps 8 bits, two parts 16
    assert ((v.double() - hi.double()).abs() <= v.abs().double() * 2.0 ** -8).all()
    assert ((v.double() - hi.double() - mid.double()).abs()
            <= v.abs().double() * 2.0 ** -16).all()


@pytest.mark.parametrize("K", [64, 256])
def test_three_part_product_is_f32_accurate(K):
    """A bf16 input times an f32 factor, over K terms: as close to the f64
    product as an f32 product of the same operands, where one part is
    three digits off."""
    x = _normal((64, K), 2).to(torch.bfloat16).float()
    f = _normal((K, 64), 3)
    want = x.double() @ f.double()
    f32_err = ((x @ f).double() - want).abs().max().item()
    err3 = (mm3(x, f).double() - want).abs().max().item()
    err1 = (mm3(x, f, 1).double() - want).abs().max().item()
    assert err3 <= 4 * f32_err + 1e-6
    assert err1 > 100 * err3


def _ssd_chunk(x, a, b, c, n_parts):
    """One chunk from a zero state with bf16 x, b, c, as the Hopper route
    computes it: scores C B^T in one pass, then (S o L) X and the state
    (X^T dec) B with the f32 factor in ``n_parts`` bf16 parts."""
    xf, bf, cf = x.float(), b.float(), c.float()
    acs = torch.cumsum(a, dim=-1)
    Q = x.shape[-2]
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    seg = torch.where(causal, acs[..., :, None] - acs[..., None, :], 0.0)
    scores = cf @ bf.transpose(-1, -2)
    sl = torch.where(causal, scores * torch.exp(seg), 0.0)
    y = mm3(xf, sl, n_parts, factor_left=True)
    dec = torch.exp(acs[..., -1:] - acs)
    state_t = mm3(bf, xf.transpose(-1, -2) * dec[..., None, :], n_parts, factor_left=True)
    return y.to(x.dtype), state_t.transpose(-1, -2)


def test_three_part_ssd_chunk_holds_the_gate():
    """One chunk of 256 at Mamba2's N = P = 64 with bf16 inputs: y within
    the bf16 gate and the f32 state within the f32 gate with three parts;
    the top part alone misses the state's gate."""
    B, H, L, P, N = 1, 2, 256, 64, 64
    x = _normal((B, H, L, P), 20, 0.5).to(torch.bfloat16)
    a = -torch.nn.functional.softplus(_normal((B, H, L), 21))
    b, c = (_normal((B, H, L, N), s, 0.3).to(torch.bfloat16) for s in (22, 23))
    want_y, want_h = ref_ssd(x, a, b, c, return_state=True)
    y, h = _ssd_chunk(x, a, b, c, 3)
    torch.testing.assert_close(y.float(), want_y.float(), **SSD_BF16_TOL)
    torch.testing.assert_close(h, want_h, **SSD_TOL)
    _, h1 = _ssd_chunk(x, a, b, c, 1)
    diff = (h1 - want_h).abs()
    assert not bool((diff <= SSD_TOL["atol"] + SSD_TOL["rtol"] * want_h.abs()).all()), \
        f"one bf16 part unexpectedly held the state's gate: max |err| {diff.max().item()}"
