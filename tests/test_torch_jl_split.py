"""The numerics of the JL projection kernel, emulated on the CPU.

On the card the kernel multiplies on the tensor cores in bf16: each sign of
R is an exact bf16 +-1, and an f32 gradient g enters as three bf16 pieces,
g1 = rn(g), g2 = rn(g - g1), g3 = rn(g - g1 - g2), whose sum is g exactly
for normal g. So every product is exact, and the f32 accumulator takes one
k16 step (16 depths) of one piece at a time. Here the pieces are formed in
torch (bf16 rounding is round to nearest even, as __float2bfloat16_rn), the
16-depth partial sums are taken in float64 (exact: 16 products of 8-bit
values by +-1), and each is added into an f32 accumulator in the kernel's
order, the smallest piece first. The result stays within
chip_smoke.JL_RTOL of `jl_project_plain` per row, the limit the kernel is
held to on the card.
"""

import numpy as np
import pytest
import torch

from chip_smoke import JL_RTOL
from group_attribution_for_diffusion_models_tpu_torch.ops import jl_project_plain, rademacher_rows
from group_attribution_for_diffusion_models_tpu_torch.ops.jl_projection import _scale


def pieces(g: torch.Tensor):
    """The three bf16 pieces of f32 g, as the kernel forms them."""
    g1 = g.to(torch.bfloat16)
    r = g - g1.float()
    g2 = r.to(torch.bfloat16)
    return g1, g2, (r - g2.float()).to(torch.bfloat16)


def emulated_projection(g: torch.Tensor, proj_dim: int, seed: int, step: int = 16,
                        block: int = 4096) -> torch.Tensor:
    """Y = G R / sqrt(P) with the kernel's pieces and f32 accumulation order."""
    b, d = g.shape
    parts = [p.double() for p in reversed(pieces(g))]  # smallest piece first
    acc = torch.zeros((b, proj_dim), dtype=torch.float32)
    for d0 in range(0, d, block):
        d1 = min(d, d0 + block)
        r = rademacher_rows(seed, d0, d1, proj_dim).double()
        n = d1 - d0
        pad = -n % step
        r = torch.nn.functional.pad(r, (0, 0, 0, pad)).reshape(-1, step, proj_dim)
        sums = [torch.einsum("bsk,skp->sbp",
                             torch.nn.functional.pad(p[:, d0:d1], (0, pad)).reshape(b, -1, step), r)
                for p in parts]
        for s in range(r.shape[0]):
            for part in sums:
                acc = (acc.double() + part[s]).float()
    return acc * _scale(proj_dim)


def test_three_bf16_pieces_sum_to_every_normal_f32_exactly():
    rng = np.random.default_rng(0)
    n = 200_000
    mant = rng.integers(0, 1 << 23, n, dtype=np.int64)
    expo = rng.integers(127 - 100, 127 + 100, n, dtype=np.int64)
    sign = rng.integers(0, 2, n, dtype=np.int64)
    bits = (sign << 31) | (expo << 23) | mant
    g = torch.from_numpy(bits.astype(np.uint32).view(np.int32)).view(torch.float32)
    g = torch.cat([g, torch.tensor([0.0, -0.0, 1.0, -1.0, 2.0**-100, 3.0 * 2**100])])
    total = sum(p.double() for p in pieces(g))
    assert torch.equal(total, g.double())
    # Two pieces keep 16 of the 24 bits: most values are not exact.
    g1, g2, _ = pieces(g)
    assert (g1.double() + g2.double() != g.double()).float().mean() > 0.5


@pytest.mark.parametrize("b,d,p", [(3, 70_001, 1000), (8, 1 << 16, 256)])
def test_emulated_projection_within_the_row_limit(b, d, p):
    g = torch.from_numpy(np.random.default_rng(7).standard_normal((b, d)).astype(np.float32))
    got = emulated_projection(g, p, seed=3)
    want = jl_project_plain(g, p, seed=3)
    err = (got - want).abs().amax(dim=1)
    limit = JL_RTOL * g.abs().sum(dim=1) / p ** 0.5
    assert (err <= limit).all()
    assert (err > 0).any()  # the orders differ; the check is not vacuous
