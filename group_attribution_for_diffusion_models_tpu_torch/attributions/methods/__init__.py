from .trak import (  # noqa: F401
    OUTPUT_FNS,
    PerSampleGradients,
    aggregate_by_group,
    compute_gradient_scores,
    feature_timesteps,
    make_grad_feature_fn,
    make_journey_feature_fn,
)
