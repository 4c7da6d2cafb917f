from .convert_diffusers import params_from_jax, params_to_jax  # noqa: F401
from .layers import (  # noqa: F401
    Conv1x1,
    Downsample,
    GroupNormSiLU,
    LoRADense,
    ResnetBlock,
    SelfAttention2D,
    TimestepEmbedding,
    Upsample,
    sinusoidal_embedding,
)
from .unet2d import UNet2D, build_unet  # noqa: F401
