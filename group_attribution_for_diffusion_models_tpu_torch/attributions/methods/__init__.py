from .databanzhaf import data_banzhaf  # noqa: F401
from .datamodel import compute_datamodel_scores, datamodel, ridge_cv  # noqa: F401
from .datashapley import (  # noqa: F401
    brute_force_shapley,
    data_shapley,
    kernel_shap,
    kernel_shap_ridge,
)
from .trak import (  # noqa: F401
    OUTPUT_FNS,
    PerSampleGradients,
    aggregate_by_group,
    compute_gradient_scores,
    feature_timesteps,
    make_grad_feature_fn,
    make_journey_feature_fn,
)
