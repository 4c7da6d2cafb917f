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
