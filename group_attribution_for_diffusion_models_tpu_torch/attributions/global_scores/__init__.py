"""Sample-based global behaviors: FID, IS, precision/recall, diversity
entropy and their towers (the diversity's BLIP tower is
``models.blip_vision``)."""

from .diversity import (  # noqa: F401
    assign_to_clusters,
    calculate_diversity_score,
    diversity_entropy,
    embedding_dist_to_mean,
    ward_cluster,
)
from .fid import (  # noqa: F401
    calculate_fid_from_features,
    compute_feature_stats,
    frechet_distance,
    load_reference_stats,
    load_stats,
    save_stats,
)
from .inception_score import inception_score_from_logits  # noqa: F401
from .inception_v3 import (  # noqa: F401
    InceptionV3,
    inception_tag,
    load_inception,
    make_feature_fn,
    params_from_jax,
)
from .precision_recall import (  # noqa: F401
    Manifold,
    build_manifold,
    compute_precision_recall,
    load_manifold,
    save_manifold,
)
from .vgg16 import VGG16Features, load_vgg16, make_vgg_feature_fn  # noqa: F401
