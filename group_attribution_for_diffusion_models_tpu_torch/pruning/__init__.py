from .structural import (  # noqa: F401
    count_params,
    magnitude_importance,
    prune_unet,
    random_importance,
    resnet_block_paths,
    taylor_importance,
)
