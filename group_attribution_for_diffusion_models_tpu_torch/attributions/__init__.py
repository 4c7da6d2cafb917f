from . import methods  # noqa: F401
from .lds import (  # noqa: F401
    bootstrap_lds_ci,
    collect_data,
    collect_local_data,
    evaluate_lds,
)
