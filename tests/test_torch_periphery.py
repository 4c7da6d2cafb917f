"""The port's periphery against the JAX package, on the CPU.

* ``python -m group_attribution_for_diffusion_models_tpu_torch`` lists the
  JAX ``__main__``'s 37 commands and dispatches them.
* `cli.runtime_report` and `cli.sweep_report` print what the JAX CLIs print
  (and return the same summary) on the DBs of tests/test_misc_cli.py and
  tests/test_reports.py.
* `cli.experiments`: gen-commands writes the JAX command file with the
  package name swapped, each line parses with the port CLI it names, and
  gen-commands -> find-incomplete -> run -> find-incomplete round-trips.
* `cli.convert_weights`: every kind but unet writes arrays bit-equal to the
  JAX CLI's from the same seeded state dict (``.pt`` and ``.safetensors``);
  unet writes a port checkpoint whose parameters equal the JAX-converted
  checkpoint's through `params_from_jax`, bit for bit; a wrong spec exits;
  a safetensors file without the package fails naming it.
* The native readers: `filter_records` equals the plain scan and the JAX
  native scan; `_load_image_dir` equals the JAX loader bit for bit (both
  native), and falls back to PIL for webp; without a compiler the bindings
  return None with a warning that names it.
* The wandb and tensorboard trackers through `cli.main`.

About 45 s of worker time alone, most of it the `run` round trip (a
subprocess training), the unet conversion and the tensorboard import.
"""

import contextlib
import io
import os
import shlex
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from group_attribution_for_diffusion_models_tpu import __main__ as jax_entry
from group_attribution_for_diffusion_models_tpu import models as jax_models
from group_attribution_for_diffusion_models_tpu.cli import convert_weights as jax_convert
from group_attribution_for_diffusion_models_tpu.cli import experiments as jax_experiments
from group_attribution_for_diffusion_models_tpu.cli import runtime_report as jax_runtime
from group_attribution_for_diffusion_models_tpu.cli import sweep_report as jax_sweep
from group_attribution_for_diffusion_models_tpu.cli.common import config_for as jax_config_for
from group_attribution_for_diffusion_models_tpu.data import datasets as jax_datasets
from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
from group_attribution_for_diffusion_models_tpu.utils import append_record
from group_attribution_for_diffusion_models_tpu.utils.native_jsonl import (
    filter_records_native as jax_filter_native,
)
from group_attribution_for_diffusion_models_tpu_torch import __main__ as entry
from group_attribution_for_diffusion_models_tpu_torch.attributions.global_scores import (
    inception_v3,
)
from group_attribution_for_diffusion_models_tpu_torch.cli import (
    convert_weights,
    experiments,
    runtime_report,
    sweep_report,
)
from group_attribution_for_diffusion_models_tpu_torch.cli import main as main_cli
from group_attribution_for_diffusion_models_tpu_torch.cli.common import config_for
from group_attribution_for_diffusion_models_tpu_torch.data import datasets
from group_attribution_for_diffusion_models_tpu_torch.models import (
    blip_vision,
    clip_text,
    clip_vision,
    ldm_bert,
    resnet,
)
from group_attribution_for_diffusion_models_tpu_torch.models.convert_diffusers import (
    params_from_jax,
)
from group_attribution_for_diffusion_models_tpu_torch.models.vqvae import VQVAE
from group_attribution_for_diffusion_models_tpu_torch.ops import _build
from group_attribution_for_diffusion_models_tpu_torch.utils import (
    jsonl,
    native_images,
    native_jsonl,
)
from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import load_checkpoint
from test_torch_tti_cli import _fast
from test_torch_unet import _jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "group_attribution_for_diffusion_models_tpu_torch"


def _printed(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(argv)
    return buf.getvalue(), result


def test_main_lists_and_dispatches_the_jax_commands(capsys):
    names = entry._commands()
    assert names == jax_entry._commands() and len(names) == 37
    assert entry.main([]) == 0
    listing = capsys.readouterr().out
    assert all(f"  {n} " in listing for n in names)
    assert entry.main(["no_such_command"]) == 2
    with pytest.raises(SystemExit, match="no timing fields"):
        entry.main(["runtime_report", "--db", os.path.join(REPO, "no_such_db.jsonl")])


def _runtime_db(path):
    """tests/test_misc_cli.py's DB: retrain and gd rows of 8 shapley seeds."""
    rng = np.random.RandomState(0)
    for s in range(8):
        v = float(rng.rand())
        append_record(path, {"method": "retrain", "removal_dist": "shapley",
                             "removal_seed": s, "fid_value": v,
                             "total_steps_time": 50.0, "sampling_time": 5.0})
        append_record(path, {"method": "gd", "removal_dist": "shapley",
                             "removal_seed": s, "fid_value": v + 0.01,
                             "total_steps_time": 5.0, "sampling_time": 5.0})


def _sweep_db(path):
    """tests/test_reports.py's (ratio, lr, steps) grid."""
    for ratio in (0.1, 0.3, 0.5):
        for lr in (1e-4, 3e-4):
            for steps in (100, 200):
                ssim = (0.9 - abs(ratio - 0.3) - (0.05 if lr > 1e-4 else 0.0)
                        + (0.02 if steps == 200 else 0.0))
                append_record(path, {
                    "exp_name": f"sweep/ratio={ratio}/lr={lr}", "pruning_ratio": ratio,
                    "lr": lr, "training_steps": steps,
                    **{f"generated_image_{i}_ssim": ssim + 0.001 * i for i in range(3)}})


def _exp_name_db(path):
    for ratio, loss in ((0.1, 0.5), (0.3, 0.2), (0.5, 0.9)):
        append_record(path, {"exp_name": f"run/ratio={ratio}/x", "loss": loss})


@pytest.mark.parametrize("name,make_db,argv", [
    ("runtime", _runtime_db, []),
    ("runtime", _runtime_db, ["--group_by", "removal_seed", "--baseline_method", "3"]),
    ("sweep", _sweep_db, ["--keys", "pruning_ratio", "lr", "training_steps",
                          "--behavior", "ssim"]),
    ("sweep", _exp_name_db, ["--keys", "ratio", "--behavior", "loss", "--minimize"]),
])
def test_reports_print_what_the_jax_clis_print(tmp_path, name, make_db, argv):
    db = str(tmp_path / "db.jsonl")
    make_db(db)
    port, jax_cli = ((runtime_report, jax_runtime) if name == "runtime"
                     else (sweep_report, jax_sweep))
    outs = {}
    for label, cli in (("port", port), ("jax", jax_cli)):
        extra = ["--out", str(tmp_path / f"{label}.json")] if name == "sweep" else []
        outs[label] = _printed(cli.main, ["--db", db, *argv, *extra])
    assert outs["port"] == outs["jax"]
    assert outs["port"][0]
    if name == "sweep":
        with open(tmp_path / "port.json") as f, open(tmp_path / "jax.json") as g:
            assert f.read() == g.read()


def _port_parse(line: str):
    """The port CLI a generated line names, parsing the line's flags."""
    import importlib

    words = shlex.split(line)
    module = words[words.index("-m") + 1]
    assert module.startswith(f"{PKG}.cli.")
    return importlib.import_module(module).parse_args(words[words.index("-m") + 2:])


def test_gen_commands_write_the_jax_file_and_parse_with_the_port(tmp_path):
    argv = ["gen-commands", "--dataset", "synthetic_64x8", "--removal_dist", "shapley",
            "--num_seeds", "10", "--chunk_size", "4", "--training_steps", "3",
            "--load", str(tmp_path / "base"), "--with_behaviors", "--outdir", str(tmp_path),
            "--db", str(tmp_path / "db.jsonl")]
    experiments.main(argv + ["--command_file", str(tmp_path / "port.txt")])
    jax_experiments.main(argv + ["--command_file", str(tmp_path / "jax.txt")])
    port = open(tmp_path / "port.txt").read()
    jax = open(tmp_path / "jax.txt").read()
    assert port == jax.replace("group_attribution_for_diffusion_models_tpu.cli.",
                               f"{PKG}.cli.")
    lines = port.splitlines()
    assert len(lines) == 3 + 10  # ceil(10 / 4) ensemble calls, one behavior call a seed
    for line in lines:
        args = _port_parse(line)
        assert args.dataset == "synthetic_64x8" and args.device == "cuda"
    assert _port_parse(lines[0]).training_steps == 3
    assert _port_parse(lines[-1]).removal_seed == 9


def test_experiments_run_roundtrip(tmp_path, monkeypatch):
    """gen-commands -> find-incomplete (both seeds missing) -> run (a real
    subprocess training on the CPU) -> find-incomplete (complete)."""
    outdir, db, cf = str(tmp_path), str(tmp_path / "db.jsonl"), str(tmp_path / "cmd.txt")
    experiments.main(["gen-commands", "--dataset", "synthetic_64x8", "--removal_dist",
                      "shapley", "--num_seeds", "2", "--chunk_size", "2", "--training_steps",
                      "2", "--outdir", outdir, "--db", db, "--command_file", cf])
    audit = ["find-incomplete", "--dataset", "synthetic_64x8", "--removal_dist", "shapley",
             "--num_seeds", "2", "--outdir", outdir, "--db", db,
             "--command_file", str(tmp_path / "retry.txt")]
    said, _ = _printed(experiments.main, audit)
    assert said.startswith("2 incomplete: seeds [0, 1]")
    for line in open(tmp_path / "retry.txt").read().splitlines():
        assert _port_parse(line).num_seeds == 1
    # The port's CLIs run on CUDA unless told otherwise: the test's lines add
    # --device cpu, and run with this interpreter from the repo root.
    with open(cf) as f:
        cmds = [f"{line.replace('python -m', f'{sys.executable} -m')} --device cpu"
                for line in f.read().splitlines()]
    with open(cf, "w") as f:
        f.write("\n".join(cmds) + "\n")
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    experiments.main(["run", "--command_file", cf])
    os.remove(tmp_path / "retry.txt")
    said, _ = _printed(experiments.main, audit)
    assert said.startswith("sweep complete")
    assert not os.path.exists(tmp_path / "retry.txt")
    assert len(list(jsonl.read_records(db))) == 2


def test_find_incomplete_reads_the_trainers_full_layout(tmp_path):
    """A --removal_dist full model lives in models/full, as the trainers
    write it; the JAX CLI looks in models/full/full (ROADMAP C4)."""
    os.makedirs(tmp_path / "synthetic_64x8" / "retrain" / "models" / "full" /
                "ckpt_steps_00000002")
    argv = ["find-incomplete", "--dataset", "synthetic_64x8", "--removal_dist", "full",
            "--num_seeds", "1", "--outdir", str(tmp_path), "--db", str(tmp_path / "db.jsonl")]
    said, _ = _printed(experiments.main, argv + ["--command_file", str(tmp_path / "p.txt")])
    assert said.startswith("sweep complete")
    said, _ = _printed(jax_experiments.main, argv + ["--command_file", str(tmp_path / "j.txt")])
    assert said.startswith("1 incomplete")
    experiments.main(["gen-commands", "--dataset", "synthetic_64x8", "--removal_dist", "full",
                      "--num_seeds", "1", "--with_behaviors", "--outdir", str(tmp_path),
                      "--db", "db.jsonl", "--command_file", str(tmp_path / "c.txt")])
    behavior = open(tmp_path / "c.txt").read().splitlines()[-1]
    assert _port_parse(behavior).load == os.path.join(str(tmp_path), "synthetic_64x8",
                                                      "retrain", "models", "full")


def _tower_state_dict(kind):
    """A seeded state dict in the layout `kind`'s converter reads: the port's
    own towers at small widths (their parameter names are the HF /
    torchvision / pytorch_fid ones)."""
    torch.manual_seed(3)
    if kind == "inception":
        sd = inception_v3.InceptionV3().state_dict()
        keep = ("Conv2d_1a_3x3.", "Mixed_5b.branch1x1.", "fc.")
        return {k: v for k, v in sd.items() if k.startswith(keep)}
    if kind == "clip_text":
        return clip_text.CLIPTextEncoder(vocab_size=40, max_length=8, width=16, layers=1,
                                         heads=2).state_dict()
    if kind in ("clip_vision", "aesthetic"):
        model = clip_vision.CLIPVisionEncoder(image_size=16, patch_size=8, width=16, layers=1,
                                              heads=2, proj_dim=8)
        if kind == "aesthetic":
            return {"layers.0.weight": torch.randn(1, 8), "layers.0.bias": torch.randn(1)}
        return model.state_dict()
    if kind == "blip_vision":
        return blip_vision.BlipVisionTower(image_size=16, patch_size=8, width=16, layers=1,
                                           heads=2, mlp_dim=32).state_dict()
    if kind == "ldm_bert":
        return ldm_bert.LDMBertEncoder(vocab_size=40, max_positions=8, d_model=16, layers=1,
                                       num_heads=2, head_dim=8, ffn_dim=32).state_dict()
    if kind == "resnet18":
        return resnet.ResNet18Features(stages=(4, 8, 8, 8), blocks=(1, 1, 1, 1)).state_dict()
    if kind == "vqvae":
        return VQVAE(config_for("synthetic_32x16_ldm").vqvae).state_dict()
    raise ValueError(kind)


def _read(path):
    """The arrays a converter wrote, by '/'-joined key."""
    if path.endswith(".npz"):
        with np.load(path) as store:
            return {k: store[k] for k in store.files}
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(np.load(path, allow_pickle=True).item(), "")
    return flat


@pytest.mark.parametrize("kind", ["inception", "clip_text", "clip_vision", "blip_vision",
                                  "ldm_bert", "resnet18", "vqvae", "aesthetic"])
@pytest.mark.parametrize("fmt", [".pt", ".safetensors"])
def test_converters_write_the_jax_clis_arrays(tmp_path, monkeypatch, kind, fmt):
    from group_attribution_for_diffusion_models_tpu.models import vqvae as jax_vqvae

    # The JAX CLI's vqvae shape check inits a flax VQVAE op by op: drawn instead.
    monkeypatch.setattr(jax_vqvae, "VQVAE", _fast(jax_vqvae.VQVAE, 4))
    sd = {k: v.contiguous() for k, v in _tower_state_dict(kind).items()}
    src = str(tmp_path / f"src{fmt}")
    if fmt == ".pt":
        torch.save(sd, src)
    else:
        from safetensors.numpy import save_file

        save_file({k: v.numpy() for k, v in sd.items()}, src)
    ext = ".npy" if kind in ("blip_vision", "vqvae") else ".npz"
    extra = ["--dataset", "synthetic_32x16_ldm"] if kind == "vqvae" else []
    for label, cli in (("port", convert_weights), ("jax", jax_convert)):
        cli.main(["--kind", kind, "--src", src, "--dst", str(tmp_path / f"{label}{ext}"),
                  *extra])
    got, want = _read(str(tmp_path / f"port{ext}")), _read(str(tmp_path / f"jax{ext}"))
    assert got.keys() == want.keys() and got
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _jax_unet_file(tmp_path):
    """A diffusers-layout .pt of a drawn synthetic_64x8 U-Net (the JAX
    package's export) and its JAX param tree."""
    from group_attribution_for_diffusion_models_tpu.models.convert_diffusers import (
        export_unet_state_dict,
    )

    params = _jax_params(jax_config_for("synthetic_64x8").unet, 5)
    src = str(tmp_path / "unet.pt")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                export_unet_state_dict(params).items()}, src)
    return src, params


def test_unet_checkpoint_equals_the_jax_converted_one(tmp_path, monkeypatch):
    """The port's checkpoint against the JAX CLI's orbax checkpoint read
    back and passed through `params_from_jax`; cli.main --load reads it."""
    from group_attribution_for_diffusion_models_tpu.training import (
        TrainState,
        make_optimizer,
    )
    from group_attribution_for_diffusion_models_tpu.utils.ckpt import (
        load_checkpoint as jax_load_checkpoint,
    )

    monkeypatch.setattr(jax_models, "UNet2D", _fast(JaxUNet2D, 6))  # its shape check's init
    src, params = _jax_unet_file(tmp_path)
    argv = ["--kind", "unet", "--src", src, "--dataset", "synthetic_64x8"]
    jax_convert.main(argv + ["--dst", str(tmp_path / "jax")])
    convert_weights.main(argv + ["--dst", str(tmp_path / "port")])
    state, _ = jax_load_checkpoint(str(tmp_path / "jax"),
                                   TrainState.create(params, make_optimizer("adam", lr=1e-4)))
    want = params_from_jax(state.params)
    got = load_checkpoint(str(tmp_path / "port"))
    assert got["step"] == 0 and got["params"].keys() == want.keys()
    for key, value in want.items():
        assert torch.equal(got["params"][key], value), key
        assert torch.equal(got["ema_params"][key], value), key
    out = main_cli.main(["--dataset", "synthetic_64x8", "--load", str(tmp_path / "port"),
                         "--training_steps", "1", "--sample_freq", "0",
                         "--outdir", str(tmp_path / "out"), "--device", "cpu"])
    assert np.isfinite(out["loss"])


def test_unet_wrong_spec_exits(tmp_path):
    src, _ = _jax_unet_file(tmp_path)
    with pytest.raises(SystemExit, match="does not match the cifar spec"):
        convert_weights.main(["--kind", "unet", "--src", src, "--dst", str(tmp_path / "bad"),
                              "--dataset", "cifar"])
    assert not os.path.exists(tmp_path / "bad")
    with pytest.raises(SystemExit, match="not a latent workload"):
        torch.save(_tower_state_dict("vqvae"), str(tmp_path / "vq.pt"))
        convert_weights.main(["--kind", "vqvae", "--src", str(tmp_path / "vq.pt"),
                              "--dst", str(tmp_path / "vq.npy"), "--dataset", "cifar"])


def test_safetensors_without_the_package_names_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    with pytest.raises(ImportError, match="safetensors"):
        convert_weights.main(["--kind", "aesthetic", "--src", str(tmp_path / "h.safetensors"),
                              "--dst", str(tmp_path / "h.npz")])


@pytest.fixture
def fresh_bindings(tmp_path, monkeypatch):
    """The bindings' build state reset before and after a test, and their
    libraries built into a directory of the test's own."""
    monkeypatch.setattr(_build, "_BUILD_DIR", str(tmp_path / "build"))
    for mod in (native_jsonl, native_images):
        mod._library.cache_clear()
    yield
    for mod in (native_jsonl, native_images):
        mod._library.cache_clear()


def _jsonl_db(path):
    """tests/test_native_jsonl.py's DB."""
    rng = np.random.RandomState(0)
    for i in range(300):
        append_record(path, {
            "exp_name": "sweep", "method": "retrain" if i % 3 == 0 else "gd",
            "removal_dist": "shapley", "removal_seed": i, "fid_value": float(rng.rand()),
            "remaining_idx": rng.choice(2000, 1000, replace=False)})


@pytest.mark.parametrize("cond,n", [({"method": "retrain", "removal_dist": "shapley"}, 100),
                                    ({"removal_seed": 7}, 1), ({"method": "gd"}, 200),
                                    ({}, 300)])
def test_native_filter_equals_the_plain_and_jax_scans(tmp_path, cond, n):
    db = str(tmp_path / "db.jsonl")
    _jsonl_db(db)
    native = native_jsonl.filter_records_native(db, cond)
    assert native is not None
    plain = jsonl.filter_records_plain(db, cond)
    assert native == plain == jax_filter_native(db, cond) == jsonl.filter_records(db, cond)
    assert len(native) == n
    assert native_jsonl.filter_records_native(str(tmp_path / "missing.jsonl"), cond) is None


def _image_dir(path, exts, seed=1):
    os.makedirs(path)
    rng = np.random.RandomState(seed)
    for i, ext in enumerate(exts):
        arr = rng.randint(0, 256, size=(20 + 4 * i, 24, 3), dtype=np.int64).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(path, f"x_{i}.{ext}"), quality=95)
    return path


@pytest.mark.parametrize("exts,size", [(("png", "jpg", "png", "jpeg"), 16),
                                       (("png", "png"), 32)])
def test_image_dir_equals_the_jax_loader(tmp_path, exts, size):
    root = _image_dir(str(tmp_path / "imgs"), exts)
    assert native_images.native_available()
    got = datasets._load_image_dir(root, size)
    want = jax_datasets._load_image_dir(root, size)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.names == want.names


def test_image_dir_falls_back_to_pil_for_webp(tmp_path):
    root = _image_dir(str(tmp_path / "webp"), ("webp", "webp"), seed=2)
    paths = [os.path.join(root, n) for n in sorted(os.listdir(root))]
    with pytest.raises(ValueError, match="could not decode"):
        native_images.load_image_batch(paths, 16)
    got = datasets._load_image_dir(root, 16)
    pil = np.stack([np.asarray(Image.open(p).convert("RGB").resize((16, 16), Image.BILINEAR))
                    for p in paths])
    np.testing.assert_array_equal(got.images, datasets._normalize(pil))
    np.testing.assert_array_equal(got.images, jax_datasets._load_image_dir(root, 16).images)


def test_bindings_without_a_compiler_warn_and_return_none(tmp_path, monkeypatch,
                                                         fresh_bindings):
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    db = str(tmp_path / "db.jsonl")
    _jsonl_db(db)
    with pytest.warns(RuntimeWarning, match=r"g\+\+ not found"):
        assert native_jsonl.filter_records_native(db, {"method": "gd"}) is None
    assert len(jsonl.filter_records(db, {"method": "gd"})) == 200  # the plain scan
    root = _image_dir(str(tmp_path / "imgs"), ("png", "jpg"))
    with pytest.warns(RuntimeWarning, match=r"g\+\+ not found"):
        assert native_images.load_image_batch([os.path.join(root, "x_0.png")], 8) is None
    assert datasets._load_image_dir(root, 8).images.shape == (2, 8, 8, 3)  # PIL
    assert not os.path.exists(tmp_path / "build")


def test_a_missing_header_is_named(tmp_path, monkeypatch, fresh_bindings):
    source = tmp_path / "needs_header.cpp"
    source.write_text('#include "no_such_header.h"\nextern "C" int f() { return 0; }\n')
    with pytest.raises(RuntimeError, match="no_such_header.h is missing"):
        _build.build_host(str(source))
    monkeypatch.setattr(native_images, "SOURCE", str(source))
    with pytest.warns(RuntimeWarning, match="no_such_header.h is missing"):
        assert not native_images.native_available()


def test_trackers_through_cli_main(tmp_path):
    argv = ["--dataset", "synthetic_64x8", "--training_steps", "2", "--log_freq", "1",
            "--sample_freq", "0", "--device", "cpu"]
    main_cli.main(argv + ["--tracker", "tensorboard", "--outdir", str(tmp_path / "tb")])
    logs = os.listdir(tmp_path / "tb" / "logs")
    assert any(n.startswith("events.out.tfevents") for n in logs)
    with pytest.raises(ImportError, match="'wandb'"):
        main_cli.main(argv + ["--tracker", "wandb", "--outdir", str(tmp_path / "wb")])


def test_tensorboard_without_the_package_names_it(tmp_path, monkeypatch):
    from group_attribution_for_diffusion_models_tpu_torch.utils import trackers

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="'tensorboard'"):
        trackers.make_tracker("tensorboard", logdir=str(tmp_path))
