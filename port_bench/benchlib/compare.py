"""The comparison that decides ``correct``: the numbers a run is judged by,
worked out from what the program produced and what the plain reference
produced from the same inputs, and each held to its limit.

Training (a record per member: each step's loss, the leaf norms of the first
gradient after the clip, of the change of the parameters after the checked
steps and, where the step keeps one, of the EMA's change):

* ``loss_rel``: the largest |loss - loss_ref| / |loss_ref| of any step;
* ``grad1_gap``, ``change_gap``, ``ema_change_gap``: by the worst leaf, the gap
  between the program's leaf norm and the reference's, over the larger of
  the reference's norm of that leaf and of the median leaf. Leaves whose
  reference gradient stays under a thousandth of the median leaf's at every
  step (a key's bias under softmax) move under Adam by round-off alone and
  are left out of the two changes.

Sampling: ``image_max_abs``, the largest |pixel - pixel_ref| over the checked
images, in [0, 1] units.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping

import numpy as np

# A leaf trains when some step's reference gradient reaches this share of
# the median leaf's.
TRAINS = 1e-3


def _leaf_gap(prog: Mapping[str, float], ref: Mapping[str, float], leaves: List[str]) -> float:
    med = float(np.median([ref[k] for k in leaves]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves)


def training_numbers(prog: List[Mapping], ref: List[Mapping]) -> Dict[str, float]:
    """The numbers of one run: `prog` and `ref` hold one record per member."""
    out = {"loss_rel": 0.0, "grad1_gap": 0.0, "change_gap": 0.0}
    if "ema_change" in ref[0]:
        out["ema_change_gap"] = 0.0
    for p, r in zip(prog, ref):
        for lp, lr in zip(p["losses"], r["losses"]):
            out["loss_rel"] = max(out["loss_rel"], abs(lp - lr) / abs(lr))
        leaves = list(r["grad1"])
        out["grad1_gap"] = max(out["grad1_gap"], _leaf_gap(p["grad1"], r["grad1"], leaves))
        med = float(np.median([r["grad_max"][k] for k in leaves]))
        moving = [k for k in leaves if r["grad_max"][k] >= TRAINS * med]
        for key in ("change", "ema_change"):
            if key in r:
                gap = _leaf_gap(p[key], r[key], moving)
                out[f"{key}_gap"] = max(out[f"{key}_gap"], gap)
    return out


def judge(numbers: Mapping[str, float], limits: Mapping[str, Mapping]) -> bool:
    """Every number finite and at most its limit; a number without a limit,
    or a limit without a number, fails."""
    if set(numbers) != set(limits):
        return False
    return all(math.isfinite(v) and v <= limits[k]["limit"] for k, v in numbers.items())
