"""The f32 numerics of the attention kernels, emulated on the CPU.

On the card the f32 forward and backward run every product on the tensor cores in TF32
(10 mantissa bits) with the 3-term split, a.b ~ a_hi.b_hi + a_hi.b_lo +
a_lo.b_hi, applied to every operand, P and dS included. The backward rounds:
x_hi = rna_tf32(x), x_lo = rna_tf32(x - x_hi). The forward truncates, as the
tensor cores read a TF32 operand's bits: x_hi = trunc_tf32(x), x_lo =
trunc_tf32(x - x_hi) (it splits Q once a block, the same pieces). Here the same rounding is emulated in torch
(round to nearest, ties away from zero, on an int32 view) and each product
is taken in float64 from the rounded operands, as the tensor cores multiply
exactly and add in f32. The backward follows `attention_bwd_plain`'s
arithmetic. Three terms stay within chip_smoke.TOL["float32"] of the f32
plain version, the tolerance the kernels are held to on the card; one term
does not.
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import TOL
from group_attribution_for_diffusion_models_tpu_torch.ops import attention_bwd_plain, attention_plain


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32: the 13 low mantissa bits dropped, to nearest
    with ties away from zero (cvt.rna.tf32.f32 for finite x)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) with its 13 low mantissa bits cleared: what the tensor cores
    read of an f32 register given as a TF32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split_product(eq: str, a: torch.Tensor, b: torch.Tensor, terms: int,
                  tf32=rna_tf32) -> torch.Tensor:
    """einsum(eq, a, b) in f32 from TF32 pieces made by `tf32`: a_hi.b_hi,
    plus a_hi.b_lo and a_lo.b_hi for terms=3."""
    a_hi, b_hi = tf32(a), tf32(b)
    pairs = [(a_hi, b_hi)]
    if terms == 3:
        pairs += [(a_hi, tf32(b - b_hi)), (tf32(a - a_hi), b_hi)]
    return sum(torch.einsum(eq, x.double(), y.double()) for x, y in pairs).float()


def split_forward(q, k, v, terms: int):
    """softmax(Q K^T / sqrt(D)) V with both products' operands split by
    truncation, as the forward kernel splits them."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = split_product("bqhd,bkhd->bhqk", q, k, terms, trunc_tf32) * scale
    return split_product("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v, terms, trunc_tf32)


def split_backward(q, k, v, do, terms: int):
    """(dq, dk, dv, lse, delta) with every product's operands split."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = split_product("bqhd,bkhd->bhqk", q, k, terms) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = split_product("bhqk,bkhd->bqhd", p, v, terms)
    delta = (o * do).sum(-1).permute(0, 2, 1)
    dp = split_product("bqhd,bkhd->bhqk", do, v, terms)
    ds = p * (dp - delta[..., None])
    dq = split_product("bhqk,bkhd->bqhd", ds, k, terms) * scale
    dk = split_product("bhqk,bqhd->bkhd", ds, q, terms) * scale
    dv = split_product("bhqk,bqhd->bkhd", p, do, terms)
    return dq, dk, dv, lse, delta


def _inputs(seed, b, sq, skv, h, d):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
                 for s in (sq, skv, skv, sq))


def _excess(got, want):
    """max over elements of |got - want| - (atol + rtol |want|): <= 0 within TOL."""
    atol, rtol = TOL["float32"]
    return ((got - want).abs() - (atol + rtol * want.abs())).max().item()


def test_tf32_truncation_clears_the_low_bits():
    x = torch.tensor([1 + 2**-10 + 2**-11, -(1 + 2**-11), 3.0, -0.0])
    assert torch.equal(trunc_tf32(x), torch.tensor([1 + 2**-10, -1.0, 3.0, -0.0]))
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi = trunc_tf32(y)
    assert (hi.abs() <= y.abs()).all() and ((y - hi).abs() < y.abs() * 2**-10).all()
    # x_lo = x - x_hi is exact in f32, and its truncation keeps all but 2^-10 of it.
    lo = y - hi
    assert torch.equal(lo.double(), y.double() - hi.double())
    assert ((lo - trunc_tf32(lo)).abs() <= lo.abs() * 2**-10).all()


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 1 + 3 * 2**-12, 3.0, -0.0])
    want = torch.tensor([1 + 2**-10, -(1 + 2**-10), 1.0, 1 + 2**-10, 3.0, -0.0])
    assert torch.equal(rna_tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    r = rna_tf32(y)
    assert (r.view(torch.int32) & 0x1FFF == 0).all()
    assert ((r - y).abs() <= y.abs() * 2**-11).all()


@pytest.mark.parametrize("b,sq,skv,h,d", [(2, 256, 256, 1, 256), (2, 130, 77, 2, 40)])
def test_three_tf32_terms_meet_the_f32_tolerance(b, sq, skv, h, d):
    q, k, v, do = _inputs(1, b, sq, skv, h, d)
    want = attention_bwd_plain(q, k, v, do)
    got = split_backward(q, k, v, do, terms=3)
    for g, w in zip(got[:3], want):
        assert _excess(g, w) <= 0
    from group_attribution_for_diffusion_models_tpu_torch.ops import attention_bwd_dq_plain

    _, lse, delta = attention_bwd_dq_plain(q, k, v, do)
    assert _excess(got[3], lse) <= 0 and _excess(got[4], delta) <= 0


def test_one_tf32_term_misses_the_f32_tolerance():
    q, k, v, do = _inputs(1, 2, 256, 256, 1, 256)
    want = attention_bwd_plain(q, k, v, do)
    got = split_backward(q, k, v, do, terms=1)
    assert max(_excess(g, w) for g, w in zip(got[:3], want)) > 0


@pytest.mark.parametrize("b,sq,skv,h,d", [(2, 256, 256, 1, 256), (2, 130, 77, 2, 40)])
def test_forward_three_tf32_terms_meet_the_f32_tolerance(b, sq, skv, h, d):
    q, k, v, _ = _inputs(2, b, sq, skv, h, d)
    assert _excess(split_forward(q, k, v, terms=3), attention_plain(q, k, v)) <= 0


def test_forward_one_tf32_term_misses_the_f32_tolerance():
    q, k, v, _ = _inputs(2, 2, 256, 256, 1, 256)
    assert _excess(split_forward(q, k, v, terms=1), attention_plain(q, k, v)) > 0
