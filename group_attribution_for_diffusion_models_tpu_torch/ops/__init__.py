from .attention import (  # noqa: F401
    attention_bwd_dkv,
    attention_bwd_dkv_plain,
    attention_bwd_dq,
    attention_bwd_dq_plain,
    attention_bwd_kernel,
    attention_bwd_plain,
    attention_kernel,
    attention_plain,
    dot_product_attention,
)
from .group_norm import (  # noqa: F401
    group_norm_bwd_kernel,
    group_norm_kernel,
    group_norm_silu,
    group_norm_silu_bwd_plain,
    group_norm_silu_forward,
    group_norm_silu_plain,
)
from .jl_projection import (  # noqa: F401
    jl_project,
    jl_project_kernel,
    jl_project_plain,
    jl_project_pytree,
    rademacher_rows,
)

KERNELS = {
    "attention_fwd": attention_kernel,
    "attention_bwd_dq": attention_bwd_dq,
    "attention_bwd_dkv": attention_bwd_dkv,
    "group_norm_fwd": group_norm_kernel,
    "group_norm_bwd": group_norm_bwd_kernel,
    "jl_projection": jl_project_kernel,
}


def launch_counts() -> dict:
    """Each CUDA kernel wrapper's launch count, by kernel."""
    return {name: fn.launches for name, fn in KERNELS.items()}
