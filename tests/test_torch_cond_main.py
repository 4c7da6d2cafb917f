"""The prompt-conditional path of `cli.main`, against the JAX package, on the
CPU.

* The conditional train step (`make_train_step(conditional=True)`) against
  the JAX ``make_train_step(conditional=True)`` on the synthetic
  cross-attention U-Net, two steps on the JAX step's own threefry draws
  with a context of 77 tokens: atol 1e-5 on the loss, rtol 1e-4 on the
  gradient norm, each tensor's move within 1% of its L2 norm (as
  tests/test_torch_main_cli.py holds the unconditional step).
* ``cli.main --dataset synthetic_64x8_cond`` beside the JAX CLI with one
  LDMBert ``.npz`` and one ``vocab.txt``: each step's context (the class
  embeddings gathered by the batch's labels) within atol 2e-5, the rows'
  keys and removal indices. The JAX CLI's LDMBert is swapped for the JAX
  package's pieces composed as diffusers composes them (pre-LN, epsilon
  1e-5; tests/test_torch_ldm_bert.py), the tower the port holds itself to;
  its U-Net init is drawn, each tower applied as one compiled program, and
  its step records the context and changes nothing.
* Both loops train with either tower on ``synthetic_64x8_cond`` and
  ``synthetic_64x16_ldm_cond``: finite losses and a conditioned sample
  grid; under ``--scan_chunk`` each step's context is the class embedding
  of each drawn image's label.
* The two runs that exit before anything is loaded (ROADMAP C4): LDMBert
  without ``--tokenizer_dir``, where the JAX CLI's row records a NaN loss,
  and ``--dataset imagenette``, whose JAX config feeds 256x256 pixels to a
  U-Net of 4x32x32 latents.
* Every CLI of the port that samples passes ``kind="ddim"`` (CIFAR's and
  MNIST's scheduler kind is "ddpm", which the sampler now honours).
"""

import ast
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from group_attribution_for_diffusion_models_tpu.cli import common as jax_common
from group_attribution_for_diffusion_models_tpu.cli import main as jax_main
from group_attribution_for_diffusion_models_tpu.config import registry as jax_registry
from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import (
    antithetic_timesteps as jax_antithetic,
)
from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import (
    make_schedule as jax_make_schedule,
)
from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
from group_attribution_for_diffusion_models_tpu.models import ldm_bert as jax_ldm_bert
from group_attribution_for_diffusion_models_tpu.training import state as jax_state
from group_attribution_for_diffusion_models_tpu.training.train import (
    make_train_step as jax_make_train_step,
)
from group_attribution_for_diffusion_models_tpu.utils import read_records as jax_read_records
from group_attribution_for_diffusion_models_tpu_torch.cli import common as port_common
from group_attribution_for_diffusion_models_tpu_torch.cli import main as main_cli
from group_attribution_for_diffusion_models_tpu_torch.data import create_dataset
from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_schedule
from group_attribution_for_diffusion_models_tpu_torch.models import UNet2D, params_from_jax
from group_attribution_for_diffusion_models_tpu_torch.models.ldm_bert import ldm_bert_spec
from group_attribution_for_diffusion_models_tpu_torch.training import (
    TrainState,
    make_optimizer,
    make_train_step,
)
from group_attribution_for_diffusion_models_tpu_torch.utils.jsonl import read_records
from test_torch_ldm_bert import PreLNEncoder, flatten
from test_torch_tti import _draw
from test_torch_tti_cli import _fast
from test_torch_unet import _port_spec

DATASET = "synthetic_64x8_cond"
PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "group_attribution_for_diffusion_models_tpu_torch")
CAPTION_WORDS = ["a", "photo", "of", ".", "tench", "english", "springer", "cassette",
                 "player", "chain", "saw", "church", "french", "horn", "garbage", "truck",
                 "gas", "pump", "golf", "ball", "parachute"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    """A vocab.txt of the captions' words and an LDMBert .npz for the
    synthetic configs' 32-wide tower (the JAX CLI's default vocabulary)."""
    root = tmp_path_factory.mktemp("towers")
    vocab = root / "vocab"
    vocab.mkdir()
    (vocab / "vocab.txt").write_text(
        "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + CAPTION_WORDS) + "\n")
    shapes = jax.eval_shape(jax_ldm_bert.LDMBertEncoder(**ldm_bert_spec(32)).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32))["params"]
    npz = str(root / "ldm_bert.npz")
    np.savez(npz, **flatten(jax.tree_util.tree_map(np.asarray, _draw(shapes, 12))))
    return str(vocab), npz


def _cond_params(spec, seed):
    shapes = jax.eval_shape(JaxUNet2D(spec).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, spec.sample_size, spec.sample_size, 3)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 32)))["params"]
    return _draw(shapes, seed)


def test_conditional_train_step_matches_the_jax_step():
    spec = jax_common.config_for(DATASET).unet
    sched = jax_common.config_for(DATASET).scheduler
    params = _cond_params(spec, 13)
    tx = jax_state.make_optimizer("adam", lr=1e-3)
    jax_step = jax.jit(jax_make_train_step(JaxUNet2D(spec).apply, tx, jax_make_schedule(sched),
                                           sched, conditional=True))
    jstate = jax_state.TrainState.create(params, tx)
    model = UNet2D(_port_spec(spec))
    model.load_state_dict(params_from_jax(params))
    port_tx = make_optimizer("adam", lr=1e-3)
    state = TrainState.create(model, port_tx)
    port_sched = port_common.config_for(DATASET).scheduler
    step = make_train_step(port_tx, make_schedule(port_sched), port_sched, conditional=True)
    rng = np.random.default_rng(14)
    for i in range(2):
        images = rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32)
        ehs = rng.standard_normal((4, 77, 32)).astype(np.float32)
        key = jax.random.PRNGKey(200 + i)
        key_t, key_n = jax.random.split(key)
        t = jax_antithetic(key_t, 4, sched.num_train_timesteps)
        noise = jax.random.normal(key_n, images.shape, dtype=jnp.float32)
        jstate, jm = jax_step(jstate, jnp.asarray(images), key,
                              encoder_hidden_states=jnp.asarray(ehs))
        metrics = step(state, torch.from_numpy(images).permute(0, 3, 1, 2),
                       timesteps=torch.tensor(np.asarray(t)).long(),
                       noise=torch.tensor(np.asarray(noise)).permute(0, 3, 1, 2),
                       encoder_hidden_states=torch.from_numpy(ehs))
        np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]), atol=1e-5, rtol=0)
        np.testing.assert_allclose(metrics["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=1e-4)
    start = params_from_jax(params)
    got = state.state_dicts()[0]
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    assert any("attn2.to_k" in n for n in want)  # the cross-attention trains
    for n, w in want.items():
        if n.endswith("to_k.bias"):
            continue  # its gradient is zero in exact arithmetic: Adam scales float noise
        moved = w - start[n]
        err = torch.linalg.vector_norm(got[n] - start[n] - moved).item()
        assert err <= 1e-2 * torch.linalg.vector_norm(moved).item(), n


def _recording_port_step(seen):
    real = main_cli.make_train_step

    def factory(*args, **kwargs):
        step = real(*args, **kwargs)

        def recorded(state, images, generator=None, encoder_hidden_states=None, **kw):
            seen.append((images.clone(), encoder_hidden_states))
            return step(state, images, generator, encoder_hidden_states=encoder_hidden_states,
                        **kw)
        return recorded
    return factory


def _recording_jax_step(seen):
    def factory(apply_fn, tx, *args, **kwargs):
        assert kwargs["conditional"]

        def step(state, images, key, encoder_hidden_states=None):
            jax.debug.callback(lambda e: seen.append(np.asarray(e)), encoder_hidden_states)
            return state, {"loss": jnp.zeros(()), "grad_norm": jnp.zeros(())}
        return step
    return factory


def test_class_embeddings_and_rows_match_the_jax_cli(tmp_path, monkeypatch, towers):
    vocab, npz = towers
    jax_seen, port_seen = [], []
    monkeypatch.setattr(jax_ldm_bert, "LDMBertEncoder", _fast(PreLNEncoder, 0))
    monkeypatch.setattr(jax_main, "UNet2D", _fast(JaxUNet2D, 21))
    monkeypatch.setattr(jax_main, "make_train_step", _recording_jax_step(jax_seen))
    monkeypatch.setattr(main_cli, "make_train_step", _recording_port_step(port_seen))
    argv = ["--dataset", DATASET, "--removal_dist", "shapley", "--removal_seed", "1",
            "--training_steps", "3", "--sample_freq", "0", "--log_freq", "1",
            "--text_encoder_weights", npz, "--tokenizer_dir", vocab]
    jax_main.main(argv + ["--outdir", str(tmp_path / "jax")])
    out = main_cli.main(argv + ["--outdir", str(tmp_path / "port"), "--device", "cpu"])
    assert len(jax_seen) == len(port_seen) == 3
    for want, (_, got) in zip(jax_seen, port_seen):
        assert got.shape == want.shape == (8, 77, 32)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    (want_row,) = jax_read_records(str(tmp_path / "jax" / f"{DATASET}_train_db.jsonl"))
    (row,) = read_records(out["db"])
    assert set(row) - {"device"} == set(want_row)
    assert row["removed_idx"] == want_row["removed_idx"] and math.isfinite(row["loss"])
    assert row["text_encoder_kind"] == "ldm_bert"


def _class_emb_recorder(store):
    real = main_cli.class_conditioning

    def wrapped(*args, **kwargs):
        tower, tokenize, emb = real(*args, **kwargs)
        store.append(emb)
        return tower, tokenize, emb
    return wrapped


@pytest.mark.parametrize("dataset,kind,extra", [
    (DATASET, "ldm_bert", []),
    (DATASET, "ldm_bert", ["--scan_chunk", "3"]),
    (DATASET, "clip", []),
    (DATASET, "clip", ["--scan_chunk", "2"]),
    ("synthetic_64x16_ldm_cond", "ldm_bert", []),
])
def test_both_loops_train_with_either_tower(tmp_path, monkeypatch, towers, dataset, kind, extra):
    from PIL import Image

    vocab, _ = towers
    seen, embs = [], []
    monkeypatch.setattr(main_cli, "make_train_step", _recording_port_step(seen))
    monkeypatch.setattr(main_cli, "class_conditioning", _class_emb_recorder(embs))
    tok = ["--tokenizer_dir", vocab] if kind == "ldm_bert" else []
    out = main_cli.main(["--dataset", dataset, "--outdir", str(tmp_path), "--training_steps",
                         "3", "--sample_freq", "3", "--n_inference_samples", "3",
                         "--text_encoder_kind", kind, "--random_text_encoder", "--device",
                         "cpu"] + tok + extra)
    assert math.isfinite(out["loss"]) and len(seen) == 3
    (emb,) = embs
    classes = 10 if dataset == DATASET else int(create_dataset(dataset).labels.max()) + 1
    assert emb.shape == (classes, 77, 32) and torch.isfinite(emb).all()
    grid = os.path.join(out["model_dir"], "samples", "steps_00000003.png")
    assert np.asarray(Image.open(grid)).shape[1] == 3 * (8 if dataset == DATASET else 16)
    if extra and dataset == DATASET:
        # The scanned loop gathers on the device: each row is its image's class.
        ds = create_dataset(DATASET)
        flat = torch.from_numpy(ds.images).permute(0, 3, 1, 2).reshape(len(ds.images), -1)
        for images, ehs in seen:
            idx = [int(torch.nonzero((flat == im.reshape(1, -1)).all(1))[0])
                   for im in images]
            assert torch.equal(ehs, emb[torch.from_numpy(ds.labels[idx]).long()])


def test_ldm_bert_without_a_vocab_exits_where_the_jax_cli_trains_on_nan(tmp_path, monkeypatch):
    """The JAX CLI falls back to the CLIP hash tokenizer: 76 of the 77 ids of
    a caption lie past LDMBert's 30522 rows, its gather fills NaN, and its
    row records a NaN loss. The port exits first and names the flag."""
    argv = ["--dataset", DATASET, "--training_steps", "1", "--sample_freq", "0",
            "--random_text_encoder"]
    monkeypatch.setattr(jax_main, "UNet2D", _fast(JaxUNet2D, 22))
    # Its tower drawn and applied in one program: the same gather, the same NaN.
    monkeypatch.setattr(jax_ldm_bert, "LDMBertEncoder", _fast(jax_ldm_bert.LDMBertEncoder, 23))
    jax_main.main(argv + ["--outdir", str(tmp_path / "jax")])
    (row,) = jax_read_records(str(tmp_path / "jax" / f"{DATASET}_train_db.jsonl"))
    assert math.isnan(row["loss"])
    with pytest.raises(SystemExit, match="--tokenizer_dir"):
        main_cli.main(argv + ["--outdir", str(tmp_path / "port"), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "port")  # nothing loaded or written


def test_imagenette_exits_before_loading_anything(tmp_path):
    cfg = jax_registry.get_config("imagenette")
    assert cfg.vqvae is None and cfg.image_size == 256  # the JAX CLI's pixel branch
    assert (cfg.unet.in_channels, cfg.unet.sample_size) == (4, 32)
    with pytest.raises(SystemExit, match="256x256 pixels, but its U-Net takes 4x32x32 latents"):
        main_cli.main(["--dataset", "imagenette", "--outdir", str(tmp_path / "o"),
                       "--tokenizer_dir", str(tmp_path), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "o")


def _sampler_uses(path):
    """(the call that names its kind, line) of every use of `make_sampler` or
    `sample_loop` in a module: a call of it, or a call that it is passed to
    (``partial(sample_loop, ...)``, a helper that calls it with its keywords)."""
    tree = ast.parse(open(path).read(), filename=path)
    parents = {child: node for node in ast.walk(tree) for child in ast.iter_child_nodes(node)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Name) and node.id in ("make_sampler", "sample_loop")
                and isinstance(node.ctx, ast.Load)):
            call = parents[node]
            assert isinstance(call, ast.Call), (path, node.lineno)
            yield call, node.lineno


def test_every_cli_samples_with_ddim():
    cli = os.path.join(PORT, "cli")
    calls = 0
    for name in sorted(os.listdir(cli)):
        if not name.endswith(".py"):
            continue
        for call, line in _sampler_uses(os.path.join(cli, name)):
            kinds = [k.value.value for k in call.keywords
                     if k.arg == "kind" and isinstance(k.value, ast.Constant)]
            assert kinds == ["ddim"], (name, line)
            calls += 1
    assert calls >= 13
    assert jax_registry.CIFAR.scheduler.kind == "ddpm"  # the trap the explicit kind avoids
