from .datasets import ArrayDataset, batch_iterator, create_dataset, make_synthetic  # noqa: F401
from .removal import (  # noqa: F401
    remove_data_by_class,
    remove_data_by_datamodel,
    remove_data_by_loo,
    remove_data_by_shapley,
    remove_data_by_shapley_paired,
    remove_data_by_uniform,
    remove_data_by_uniform_paired,
    remove_data_for_aoi,
    removal_masks,
    removed_by_classes,
    sample_removal,
)
