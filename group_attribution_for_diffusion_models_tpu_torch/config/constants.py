"""Path roots and enum constants for the framework.

The reference requires a hand-created ``src/constants.py`` with undocumented
members (reference README.md:19-28; SURVEY.md §5.6). Here every constant is
env-var-overridable with a sane default so the framework runs out of the box.
"""

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATASET_DIR = os.environ.get("GADM_DATASET_DIR", os.path.join(_REPO_ROOT, "datasets"))
OUTDIR = os.environ.get("GADM_OUTDIR", os.path.join(_REPO_ROOT, "results"))
LOGDIR = os.environ.get("GADM_LOGDIR", os.path.join(_REPO_ROOT, "logs"))
TMP_OUTDIR = os.environ.get("GADM_TMP_OUTDIR", os.path.join(_REPO_ROOT, "tmp_results"))
PRETRAINEDMODEL_DIR = os.environ.get(
    "GADM_PRETRAINEDMODEL_DIR", os.path.join(_REPO_ROOT, "pretrained")
)
GLOBAL_MODEL_BEHAVIOR_DIR = os.environ.get(
    "GADM_GLOBAL_MODEL_BEHAVIOR_DIR", os.path.join(OUTDIR, "global_behaviors")
)
MAX_NUM_SAMPLE_IMAGES_TO_SAVE = int(
    os.environ.get("GADM_MAX_NUM_SAMPLE_IMAGES_TO_SAVE", "64")
)

# Supported dataset / method enums (reference main.py:51,95 argparse choices).
DATASET = [
    "mnist",
    "cifar",
    "cifar2",
    "cifar100",
    "cifar100_f",
    "cifar100_new",
    "celeba",
    "imagenette",
]
METHOD = [
    "retrain",
    "prune_fine_tune",
    "gd",
    "gd_u",
    "ga",
    "ga_u",
    "esd",
    "iu",
    "iu_u",
    "lora",
    "lora_u",
    "if",
]
REMOVAL_DIST = [
    "uniform", "uniform_paired", "datamodel", "shapley", "shapley_paired",
    "loo", "aoi",
    "by_class", "full",
    # explicit mask rows (--removal_masks): exhaustive ground-truth sweeps
    "enum",
]
