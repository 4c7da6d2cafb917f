from .woodfisher import (  # noqa: F401
    apply_perturbation,
    average_gradient,
    batch_gradient,
    influence_unlearn,
    woodfisher_inv_hvp,
    woodfisher_recursion,
)
