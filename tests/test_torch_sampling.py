"""The port's DDIM sampler and generate_samples CLI.

`sample_loop` runs 5 DDIM steps of the tiny synthetic U-Net next to the JAX
package's, with the JAX sampler's own initial noise (its `key_init` split)
handed to the port as `init_noise`, on the same bridged weights. Tolerance:
atol 1e-4 on images in [0, 1] (float32 U-Nets agree to ~1e-5 per step).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.cli.common import (
    config_for as jax_config_for,
)
from group_attribution_for_diffusion_models_tpu.diffusion.sampling import (
    make_sampler as jax_make_sampler,
)
from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
from group_attribution_for_diffusion_models_tpu_torch.cli import generate_samples
from group_attribution_for_diffusion_models_tpu_torch.cli.common import config_for
from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_sampler
from group_attribution_for_diffusion_models_tpu_torch.models import build_unet, params_to_jax
from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import save_checkpoint


def test_ddim_sample_loop_matches_jax():
    cfg = config_for("synthetic_32x8")
    spec = cfg.unet
    model = build_unet(spec, seed=0).eval()
    params = params_to_jax(model.state_dict())
    b, s, c = 3, spec.sample_size, spec.in_channels

    jcfg = jax_config_for("synthetic_32x8")
    key = jax.random.PRNGKey(7)
    jax_sampler = jax_make_sampler(JaxUNet2D(jcfg.unet).apply, jcfg.scheduler, (b, s, s, c),
                                   num_inference_steps=5, kind="ddim")
    want = np.asarray(jax_sampler(jax.tree_util.tree_map(jnp.asarray, params), key))
    key_init, _ = jax.random.split(key)  # as sample_loop splits it
    noise = np.array(jax.random.normal(key_init, (b, s, s, c), dtype=jnp.float32))

    sampler = make_sampler(model, cfg.scheduler, (b, c, s, s), device="cpu",
                           num_inference_steps=5, kind="ddim")
    got = sampler(init_noise=torch.from_numpy(noise).permute(0, 3, 1, 2))
    assert got.shape == (b, c, s, s)
    got = got.permute(0, 2, 3, 1).numpy()
    assert 0.05 < (0.0 < want).mean() and (want < 1.0).mean() > 0.5  # not saturated
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _write_ckpt(model_dir, spec):
    model = build_unet(spec, seed=1)
    sd = model.state_dict()
    save_checkpoint(model_dir, 10, sd, sd, unet_spec=spec)


def _png_bytes(outdir):
    names = sorted(n for n in os.listdir(outdir) if n.endswith(".png"))
    return {n: open(os.path.join(outdir, n), "rb").read() for n in names}


def test_generate_samples_writes_pngs_and_resumes(tmp_path, capsys):
    from PIL import Image

    spec = config_for("synthetic_32x8").unet
    model_dir, out = str(tmp_path / "model"), str(tmp_path / "samples")
    _write_ckpt(model_dir, spec)
    argv = ["--dataset", "synthetic_32x8", "--load", model_dir, "--sample_outdir", out,
            "--n_samples", "3", "--batch_size", "2", "--num_inference_steps", "2",
            "--device", "cpu"]
    generate_samples.main(argv)
    first = _png_bytes(out)
    assert sorted(first) == [f"sample_{i:06d}.png" for i in range(3)]
    img = np.asarray(Image.open(os.path.join(out, "sample_000000.png")))
    assert img.shape == (spec.sample_size, spec.sample_size, 3) and img.dtype == np.uint8
    with open(os.path.join(out, "generation_state.json")) as f:
        assert json.load(f) == {"done_batches": [0, 1]}

    # Interrupted after batch 0: the rerun redoes only batch 1, identically.
    with open(os.path.join(out, "generation_state.json"), "w") as f:
        json.dump({"done_batches": [0]}, f)
    os.remove(os.path.join(out, "sample_000002.png"))
    os.remove(os.path.join(out, "sample_000000.png"))
    capsys.readouterr()
    generate_samples.main(argv)
    assert "resuming: 1 batches already complete" in capsys.readouterr().out
    again = _png_bytes(out)
    assert "sample_000000.png" not in again  # batch 0 was skipped
    assert again["sample_000002.png"] == first["sample_000002.png"]


def test_generate_samples_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable here")
    spec = config_for("synthetic_32x8").unet
    _write_ckpt(str(tmp_path / "model"), spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate_samples.main(["--dataset", "synthetic_32x8", "--load",
                               str(tmp_path / "model"), "--sample_outdir",
                               str(tmp_path / "s")])
    assert not os.path.exists(tmp_path / "s")
