"""The plain reference against the program at tiny sizes on the CPU: the same
state-dict layout, the same forward, the same DDIM images."""

import json
import os

import pytest
import torch

import tiny  # noqa: F401  (puts the benchmark's directory on the path)
from benchlib import models, runner
from benchlib.weights import lecun_state_dict
from reference.diffusion import ddim_sample
from reference.unet import lora_targets


def _port():
    return runner.import_port(tiny.ROOT)


def _config(name):
    if name.startswith("tiny"):
        return tiny.config(name)
    with open(os.path.join(tiny.BENCH_DIR, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["tiny_cifar", "tiny_sd", "cifar_ddpm", "minisd_lora"])
def test_state_dict_layout_matches_the_program(name):
    cfg = _config(name)
    port = _port()
    from group_attribution_for_diffusion_models_tpu_torch.models.unet2d import empty_unet

    program = empty_unet(models.unet_spec(port, cfg), device="meta").state_dict()
    ref = models.reference_unet(cfg, "meta").state_dict()
    assert {k: tuple(v.shape) for k, v in ref.items()} == \
        {k: tuple(v.shape) for k, v in program.items()}
    if "parameters" in cfg:
        assert sum(v.numel() for v in ref.values()) == cfg["parameters"]


def test_minisd_lora_parameter_count():
    cfg = _config("minisd_lora")
    ref = models.reference_unet(cfg, "meta")
    r = cfg["lora"]["rank"]
    n = sum(min(r, m.in_features, m.out_features) * (m.in_features + m.out_features)
            for _, m in lora_targets(ref))
    assert n == cfg["lora"]["parameters"]


@pytest.mark.parametrize("name", ["tiny_cifar", "tiny_sd"])
def test_forward_matches_the_program(name):
    torch.manual_seed(0)
    cfg = _config(name)
    port = _port()
    from group_attribution_for_diffusion_models_tpu_torch.models.lora import lora_collection
    from group_attribution_for_diffusion_models_tpu_torch.models.unet2d import empty_unet

    ref = models.reference_unet(cfg, "meta")
    weights = lecun_state_dict(ref, 7, "cpu")
    ref.load_state_dict(weights, assign=True)
    program = empty_unet(models.unet_spec(port, cfg), device="cpu")
    program.load_state_dict(weights)
    u = cfg["unet"]
    x = torch.randn(3, u["in_channels"], u["sample_size"], u["sample_size"])
    t = torch.tensor([1, 500, 999])
    ctx = torch.randn(3, 5, u["cross_attention_dim"]) if u.get("cross_attention_dim") else None
    extra = {}
    if ctx is not None:  # a LoRA branch on every projection, as the LoRA cell runs
        tree = {}
        for n, m in lora_targets(ref):
            down, up = torch.randn(m.in_features, 2) / 2, torch.randn(2, m.out_features) / 4
            m.lora = (down, up)
            tree[n] = {"down": down, "up": up}
        extra = lora_collection(tree)
    with torch.no_grad():
        want = ref(x, t, ctx)
        args = (x, t) if ctx is None else (x, t, ctx)
        got = torch.func.functional_call(program, {**dict(program.named_parameters()), **extra},
                                         args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_ddim_matches_the_program_sampler():
    cfg = _config("tiny_cifar")
    port = _port()
    from group_attribution_for_diffusion_models_tpu_torch.diffusion.sampling import make_sampler
    from group_attribution_for_diffusion_models_tpu_torch.models.unet2d import empty_unet

    ref = models.reference_unet(cfg, "meta")
    weights = lecun_state_dict(ref, 3, "cpu")
    ref.load_state_dict(weights, assign=True)
    program = empty_unet(models.unet_spec(port, cfg), device="cpu")
    program.load_state_dict(weights)
    noise = torch.randn(2, 3, 8, 8)
    sampler = make_sampler(program, models.scheduler_spec(port, cfg), tuple(noise.shape),
                           device="cpu", num_inference_steps=10, kind="ddim")
    want = ddim_sample(lambda x, t, c: ref(x, t), cfg["scheduler"], noise, 10)
    torch.testing.assert_close(sampler(init_noise=noise), want, rtol=0, atol=2e-5)


def test_reference_imports_nothing_of_the_program():
    import ast

    for name in os.listdir(os.path.join(tiny.BENCH_DIR, "reference")):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(tiny.BENCH_DIR, "reference", name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for mod in mods:
                assert mod.split(".")[0] not in ("benchlib", runner.PORT) + runner.FORBIDDEN, \
                    (name, mod)
