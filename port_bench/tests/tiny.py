"""Tiny cells for the CPU tests: the benchmark's drivers, readers and
comparison at sizes a CPU runs in seconds, in a manifest of their own.

`make_bench(tmp)` writes a ``BENCHMARK.json`` with one tiny cell of each
driver and a copy of the benchmark's directory holding their configuration,
traffic and limits files, and returns its `Manifest`. The program itself is
imported from the repository, as a run imports it.
"""

import copy
import json
import os
import shutil
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)

SCHED = {"num_train_timesteps": 1000, "beta_start": 0.0001, "beta_end": 0.02,
         "beta_schedule": "linear", "prediction_type": "epsilon", "clip_sample": True,
         "clip_sample_range": 1.0, "variance_type": "fixed_large", "timestep_spacing": "leading",
         "steps_offset": 0, "set_alpha_to_one": True}
PRECISION = {"dtype": "float32", "allow_tf32": False, "cudnn_deterministic": True}

TINY_CIFAR = {
    "name": "tiny_cifar",
    "unet": {"sample_size": 8, "in_channels": 3, "out_channels": 3, "block_out_channels": [8, 16],
             "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
             "up_block_types": ["AttnUpBlock2D", "UpBlock2D"], "layers_per_block": 1,
             "attention_head_dim": None, "norm_num_groups": 4, "norm_eps": 1e-6,
             "downsample_padding": 0, "flip_sin_to_cos": False, "freq_shift": 1.0,
             "add_attention": True, "cross_attention_dim": None},
    "scheduler": SCHED,
    "train": {"optimizer": {"name": "adam", "lr": 1e-4, "weight_decay": 0.0,
                            "lr_schedule": "constant", "grad_clip_norm": 1.0},
              "ema_max_decay": 0.9999},
    "data": {"images": 400, "hwc": [8, 8, 3], "classes": 4},
    "precision": PRECISION, "reduced": [],
}
TINY_SD = {
    "name": "tiny_sd",
    "unet": {"sample_size": 8, "in_channels": 4, "out_channels": 4, "block_out_channels": [16, 32],
             "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
             "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"], "layers_per_block": 1,
             "attention_head_dim": 2, "norm_num_groups": 4, "norm_eps": 1e-5,
             "downsample_padding": 1, "flip_sin_to_cos": True, "freq_shift": 0.0,
             "add_attention": True, "cross_attention_dim": 32, "gelu": "tanh",
             "transformer_layer_norm_eps": 1e-6},
    "scheduler": dict(SCHED, beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
                      clip_sample=False, steps_offset=1),
    "lora": {"rank": 4},
    "train": {"optimizer": {"name": "adamw", "lr": 3e-4, "weight_decay": 1e-6,
                            "lr_schedule": "cosine", "total_steps": 200, "grad_clip_norm": 1.0}},
    "data": {"images": 300, "groups": 20, "latent_chw": [4, 8, 8], "caption_shape": [5, 32],
             "group_size_sigma": 1.0},
    "precision": PRECISION, "reduced": [],
}
TRAFFIC = {
    "tiny_ensemble": {"driver": "ensemble_train", "members": 2, "batch": 8, "chunk": 2,
                      "checked_steps": 3, "traced_steps": 2},
    "tiny_lora": {"driver": "lora_train", "members": 2, "batch": 4, "checked_steps": 3,
                  "traced_steps": 1, "reference_microbatch": 2},
    "tiny_ddim": {"driver": "ddim_sample", "batch": 4, "num_inference_steps": 5, "eta": 0.0,
                  "checked_images": 6, "reference_batch": 4},
}
# Limits for CPU runs: both sides compute in float32 on one CPU.
TRAIN_LIMITS = {"loss_rel": 1e-4, "grad1_gap": 1e-3, "change_gap": 1e-2, "ema_change_gap": 1e-2}
CELLS = {
    "tiny_ensemble_train": ("tiny_cifar", "tiny_ensemble", TRAIN_LIMITS),
    "tiny_lora_train": ("tiny_sd", "tiny_lora",
                        {k: v for k, v in TRAIN_LIMITS.items() if k != "ema_change_gap"}),
    "tiny_ddim_sample": ("tiny_cifar", "tiny_ddim", {"image_max_abs": 1e-4}),
}


def make_bench(tmp: str):
    """A manifest of the tiny cells under `tmp` (a copy of the benchmark's
    directory with their files added)."""
    from benchlib.manifest import Manifest

    bench = os.path.join(tmp, "port_bench")
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    for cfg in (TINY_CIFAR, TINY_SD):
        with open(os.path.join(bench, "configs", f"{cfg['name']}.json"), "w") as f:
            json.dump(cfg, f)
        manifest["configs"].append({"name": cfg["name"], "source": "tests",
                                    "file": f"port_bench/configs/{cfg['name']}.json",
                                    "reduced": [], "why": "CPU tests"})
    for name, tr in TRAFFIC.items():
        with open(os.path.join(bench, "traffic", f"{name}.json"), "w") as f:
            json.dump(tr, f)
    for cell, (cfg, tr, limits) in CELLS.items():
        manifest["workloads"].append({"name": cell, "config": cfg, "traffic": tr, "chips": 1,
                                      "why": "CPU tests"})
        with open(os.path.join(bench, "limits", f"{cell}.json"), "w") as f:
            json.dump({"limits": {k: {"limit": v} for k, v in limits.items()}}, f)
    suffix = {"tiny_ddim_sample": "sample"}
    for m in manifest["end_to_end"]:
        if "workloads" in m:
            kind = "images_per_s" if m["name"] == "images_per_s" else "member_steps_per_s"
            m["workloads"] += [c for c in CELLS if (c in suffix) == (kind == "images_per_s")]
    for m in manifest["per_layer"]:
        m["workloads"] += [c for c in CELLS
                           if suffix.get(c, "train") == m["name"].rsplit(".", 1)[1]]
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    return Manifest(tmp, bench)


def config(name: str) -> dict:
    return copy.deepcopy({"tiny_cifar": TINY_CIFAR, "tiny_sd": TINY_SD}[name])
