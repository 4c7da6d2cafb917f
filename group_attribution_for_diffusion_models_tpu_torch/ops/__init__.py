"""The hand-written CUDA kernels' wrappers, their plain versions and launch
counts.

A process started with ``GADM_LAUNCH_LOG=<file>`` in its environment appends
one JSON line to that file as it exits: its pid, argv and `launch_counts`. A
parent of subprocesses (``chip_smoke.py``'s ``[scripts]`` phase runs the
experiment scripts' CLIs) reads their launches from it.
"""

import atexit
import json
import os
import sys

from .attention import (  # noqa: F401
    attention_bwd_dkv,
    attention_bwd_dkv_plain,
    attention_bwd_dq,
    attention_bwd_dq_plain,
    attention_bwd_kernel,
    attention_bwd_plain,
    attention_bwd_plain_route,
    attention_kernel,
    attention_plain,
    attention_plain_route,
    dot_product_attention,
    kernel_takes,
)
from .group_norm import (  # noqa: F401
    group_norm_bwd_kernel,
    group_norm_kernel,
    group_norm_silu,
    group_norm_silu_bwd_plain,
    group_norm_silu_forward,
    group_norm_silu_plain,
)
from .jl_projection import (  # noqa: F401
    jl_project,
    jl_project_kernel,
    jl_project_plain,
    jl_project_pytree,
    rademacher_rows,
)

KERNELS = {
    "attention_fwd": attention_kernel,
    "attention_bwd_dq": attention_bwd_dq,
    "attention_bwd_dkv": attention_bwd_dkv,
    "group_norm_fwd": group_norm_kernel,
    "group_norm_bwd": group_norm_bwd_kernel,
    "jl_projection": jl_project_kernel,
}


# The plain f32 attention on the card for head dims the kernels do not take:
# counted apart from the kernels.
PLAIN_ROUTES = {
    "attention_plain_fwd": attention_plain_route,
    "attention_plain_bwd": attention_bwd_plain_route,
}


def launch_counts() -> dict:
    """Each CUDA kernel wrapper's launch count, by kernel."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def route_counts() -> dict:
    """Calls of each plain route on the card, by route."""
    return {name: fn.launches for name, fn in PLAIN_ROUTES.items()}


LAUNCH_LOG_ENV = "GADM_LAUNCH_LOG"


def _append_launch_log(path: str) -> None:
    with open(path, "a") as f:
        f.write(json.dumps({"pid": os.getpid(), "argv": sys.argv,
                            "launches": launch_counts()}) + "\n")


if os.environ.get(LAUNCH_LOG_ENV):
    atexit.register(_append_launch_log, os.environ[LAUNCH_LOG_ENV])
