"""The table of peaks and the work of each of the program's kernel launches.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W power limit): 3.35 TB/s of HBM, 67 TFLOP/s of float32 outside the
tensor cores, 495 TFLOP/s of TF32 and 989 of bf16 on them. An f32-accurate
product on the tensor cores takes three TF32 products, so f32 work is held
to 495 / 3 = 165 TFLOP/s: no f32-accurate route can read above it.

`launch_bound_s` is the least time of one launch of the program's attention
(B1 forward, B2 dQ and dK/dV passes) or GroupNorm (B3 forward, B4 backward)
kernel, from the shape its ``gadm::<kernel>(dims)`` profiler range names:
the larger of its bytes over the HBM rate and its operations over the rate
of its route (the tensor cores for attention, the FMA units for GroupNorm).
Attention counts its least operations in units of B*H*Sq*Skv*D products of
two FLOPs: the forward two products (S, P.V), the dQ pass three (S, dP,
dS.K), the dK/dV pass four (S, dP, dV, dK); its bytes are each input read
once and each output written once. GroupNorm is counted by bytes alone.
"""

from __future__ import annotations

from typing import Dict, Optional

HBM_BYTES_PER_S = 3.35e12
F32_FMA_FLOPS = 67e12
TF32_FLOPS = 495e12
F32_TENSOR_FLOPS = TF32_FLOPS / 3  # 165e12
BF16_FLOPS = 989e12

# The whole step's peak, by the precision a configuration states.
STEP_PEAK_FLOPS = {"float32": F32_TENSOR_FLOPS, "bfloat16": BF16_FLOPS}
ATTENTION_FLOPS = {"float32": F32_TENSOR_FLOPS, "bfloat16": BF16_FLOPS}
_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}
_ATTN_PRODUCTS = {"attention_fwd": 2, "attention_bwd_dq": 3, "attention_bwd_dkv": 4}

ATTENTION_KERNELS = tuple(_ATTN_PRODUCTS)
GROUP_NORM_KERNELS = ("group_norm_fwd", "group_norm_bwd")


def parse_dims(text: str) -> Dict[str, object]:
    """The fields of a ``gadm::<kernel>(k=v,...)`` range."""
    out: Dict[str, object] = {}
    for part in filter(None, text.split(",")):
        key, _, value = part.partition("=")
        out[key] = int(value) if value.lstrip("-").isdigit() else value
    return out


def launch_bound_s(kernel: str, dims: Dict[str, object]) -> Optional[float]:
    """Least seconds of one launch of `kernel` at `dims`, or None for a
    kernel this table does not know."""
    if kernel in _ATTN_PRODUCTS:
        b, h, sq, skv, d = (dims[k] for k in ("B", "H", "Sq", "Skv", "D"))
        es = _BYTES[dims["dtype"]]
        q, kv = b * sq * h * d, b * skv * h * d
        flops = 2.0 * _ATTN_PRODUCTS[kernel] * b * h * sq * skv * d
        nbytes = {"attention_fwd": 2 * q + 2 * kv,           # q, k, v in; o out
                  "attention_bwd_dq": 3 * q + 2 * kv,        # q, k, v, dO in; dQ out
                  "attention_bwd_dkv": 2 * q + 4 * kv}[kernel] * es  # q, k, v, dO in; dK, dV out
        return max(nbytes / HBM_BYTES_PER_S, flops / ATTENTION_FLOPS[dims["dtype"]])
    if kernel in GROUP_NORM_KERNELS:
        n = dims["B"] * dims["C"] * dims["HW"]
        es = _BYTES[dims["dtype"]]
        stats = 2 * dims["B"] * dims["G"] * 4
        if kernel == "group_norm_fwd":
            nbytes = n * (es + _BYTES[dims.get("out", dims["dtype"])]) + 2 * dims["C"] * 4 + stats
        else:
            nbytes = 3 * n * es + 4 * dims["C"] * 4 + stats
        return nbytes / HBM_BYTES_PER_S
    return None
