from .attention import (  # noqa: F401
    attention_kernel,
    attention_plain,
    dot_product_attention,
)
from .group_norm import (  # noqa: F401
    group_norm_kernel,
    group_norm_silu,
    group_norm_silu_forward,
    group_norm_silu_plain,
)
