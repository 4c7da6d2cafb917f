from .ensemble import EnsembleTrainer, derived_seed, pad_member_indices  # noqa: F401
