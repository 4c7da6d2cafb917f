"""The port's text-to-image training step, sampler and CLIs against the JAX
package's, on the CPU.

One LoRA member step (AdamW with weight decay 1e-6 under a cosine
schedule, the clip, the min-SNR weighting) runs on injected batch indices,
timesteps and noise in both packages from the same numpy-drawn tiny
conditional U-Net and LoRA tree; `--microbatch` is held against the whole
batch; DDIM with a text context runs from the JAX loop's own initial noise;
and the three CLIs run end to end on ``synthetic_64x8`` beside the JAX
CLIs. Tolerances, f32: the loss within 1e-5 relative; the gradients within
1e-4 of each leaf's largest entry (as test_torch_tti.py's, a backward in
another order; the accumulated one against the whole batch's alike); the
LoRA leaves after one AdamW step within 1e-6 (lr 1e-3: Adam moves an
element by lr * g / (|g| + 1e-8)), except where the gradient is inside that
1e-4 band around 0, where float noise may turn Adam's step anywhere up to
2 lr, which such elements are held to; DDIM images in [0, 1] within 1e-4.
Removal splits, DB row keys, info.csv and pruned npz files are compared
exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.cli import prune_lora as jax_prune_cli
from group_attribution_for_diffusion_models_tpu.cli import (
    generate_samples_tti as jax_generate_cli,
)
from group_attribution_for_diffusion_models_tpu.cli import (
    train_text_to_image_lora as jax_train_cli,
)
from group_attribution_for_diffusion_models_tpu.config.registry import (
    SchedulerSpec as JaxSchedulerSpec,
)
from group_attribution_for_diffusion_models_tpu.diffusion.sampling import (
    sample_loop as jax_sample_loop,
)
from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import (
    add_noise as jax_add_noise,
)
from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import (
    make_schedule as jax_make_schedule,
)
from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
from group_attribution_for_diffusion_models_tpu.models import clip_text as jax_clip
from group_attribution_for_diffusion_models_tpu.models import lora as jax_lora
from group_attribution_for_diffusion_models_tpu.training.state import (
    make_optimizer as jax_make_optimizer,
)
from group_attribution_for_diffusion_models_tpu_torch.cli import (
    generate_samples_tti,
    prune_lora,
    train_text_to_image_lora,
)
from group_attribution_for_diffusion_models_tpu_torch.config.registry import SchedulerSpec
from group_attribution_for_diffusion_models_tpu_torch.diffusion.sampling import sample_loop
from group_attribution_for_diffusion_models_tpu_torch.diffusion.schedulers import make_schedule
from group_attribution_for_diffusion_models_tpu_torch.models.convert_diffusers import (
    lora_tree_from_jax,
    lora_tree_to_jax,
)
from group_attribution_for_diffusion_models_tpu_torch.models.lora import (
    load_lora_npz,
    lora_ranks,
    stack_lora_trees,
    unstack_lora_tree,
)
from group_attribution_for_diffusion_models_tpu_torch.training.state import make_optimizer
from group_attribution_for_diffusion_models_tpu_torch.utils import jsonl
from test_torch_tti import SPEC, _draw, _lora_tree, _nchw, _port_unet, _unet_params

DATASET = "synthetic_64x8"
LR, STEPS, GAMMA = 1e-3, 10, 5.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case():
    """A tiny conditional U-Net, a LoRA tree with both factors nonzero, 12
    latents of 3 artists' captions and one batch of injected draws."""
    params = _unet_params(0)
    rng = np.random.default_rng(20)
    data = dict(
        latents=rng.standard_normal((12, 8, 8, 4)).astype(np.float32),
        emb=rng.standard_normal((3, 6, 32)).astype(np.float32),
        img_artist=np.array([0, 1, 2, 0, 1, 2, 2, 1, 0, 0, 1, 2], np.int64),
        idx=np.array([3, 7, 11, 0], np.int64),
        t=np.array([5, 999, 250, 620], np.int64),
        noise=rng.standard_normal((4, 8, 8, 4)).astype(np.float32))
    return params, _lora_tree(params, 21), data


def _port_step_args(data, device="cpu"):
    return (torch.from_numpy(data["latents"]).permute(0, 3, 1, 2).contiguous(),
            torch.from_numpy(data["emb"]), torch.from_numpy(data["img_artist"]),
            torch.from_numpy(data["idx"]), torch.from_numpy(data["t"]),
            _nchw(data["noise"]))


def _port_members(params, lora_nps, draws, steps, microbatch=0):
    """(losses (steps, M), stacked LoRA tree after the first step, the stacked
    first moment after it, i.e. 0.1 x the clipped gradients) of `steps`
    port `members_step`s of the members `lora_nps` (JAX trees) on injected
    draws, one (idx, t, noise) of numpy arrays a member."""
    model = _port_unet(params).requires_grad_(False)
    tree = stack_lora_trees([lora_tree_from_jax(lo) for lo in lora_nps])
    leaves = train_text_to_image_lora.lora_leaves(tree)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tx = make_optimizer("adamw", lr=LR, weight_decay=1e-6, lr_schedule="cosine",
                        total_steps=STEPS)
    state = tx.init(leaves)
    schedule = make_schedule(SchedulerSpec())
    snr = schedule.alphas_cumprod / (1.0 - schedule.alphas_cumprod)
    latents, emb, img_artist = _port_step_args(draws[0])[:3]
    idx, t, noise = (torch.stack(x) for x in zip(*(_port_step_args(d)[3:] for d in draws)))
    losses, first = [], None
    for _ in range(steps):
        losses.append(train_text_to_image_lora.members_step(
            model, tree, tx, state, latents, emb, img_artist, idx, t, noise, schedule, snr,
            GAMMA, microbatch).tolist())
        if first is None:
            first = ({n: {k: v.detach().clone() for k, v in ab.items()} for n, ab in tree.items()},
                     [m.clone() for m in state.mu])
    after, mu = first
    names = [(n, k) for n in tree for k in ("down", "up")]
    moments = {}
    for (n, k), m in zip(names, mu):
        moments.setdefault(n, {})[k] = m
    return np.asarray(losses), after, moments


def _port_run(params, lora_np, data, steps, microbatch=0):
    """(losses, LoRA tree after `steps` port member steps, the first
    moment after the first step, i.e. 0.1 x its clipped gradient), JAX names:
    one member, stacked alone."""
    losses, after, moments = _port_members(params, [lora_np], [data], steps, microbatch)
    return (losses[:, 0].tolist(), lora_tree_to_jax(unstack_lora_tree(after, 0)),
            lora_tree_to_jax(unstack_lora_tree(moments, 0)))


def _assert_first_adam_step_close(got, want, grads):
    """The leaves after one AdamW step, by the rule in the module docstring."""
    for name, ab in want.items():
        for leaf, w in ab.items():
            g = np.abs(np.asarray(grads[name][leaf]))
            noisy = g <= 1e-4 * g.max()
            diff = np.abs(got[name][leaf] - np.asarray(w))
            assert (diff[~noisy] <= 1e-6).all(), (name, leaf, diff[~noisy].max())
            assert (diff[noisy] <= 2 * LR).all(), (name, leaf)


def _assert_grads_close(got, want):
    for name, ab in want.items():
        for leaf, w in ab.items():
            w = np.asarray(w)
            np.testing.assert_allclose(got[name][leaf], w, atol=1e-4 * np.abs(w).max(),
                                       rtol=0, err_msg=f"{name}::{leaf}")


def test_member_step_matches_the_step_built_from_jax_pieces(case):
    params, lora_np, data = case
    model = JaxUNet2D(SPEC)
    schedule = jax_make_schedule(JaxSchedulerSpec())
    acp = np.asarray(schedule.alphas_cumprod)
    snr = jnp.asarray(acp / (1.0 - acp))
    tx = jax_make_optimizer("adamw", lr=LR, weight_decay=1e-6, lr_schedule="cosine",
                            total_steps=STEPS)
    lat = jnp.asarray(data["latents"][data["idx"]])
    ehs = jnp.asarray(data["emb"][data["img_artist"][data["idx"]]])
    t, noise = jnp.asarray(data["t"]), jnp.asarray(data["noise"])

    def loss_fn(lo):  # the JAX CLI's member loss
        x_t = jax_add_noise(schedule, lat, noise, t)
        eps = model.apply({"params": params, "lora": jax_lora.lora_collection(lo)}, x_t, t, ehs)
        err = jnp.mean((eps - noise) ** 2, axis=(1, 2, 3))
        return jnp.mean(err * jnp.minimum(snr[t], GAMMA) / snr[t])

    @jax.jit
    def step(lo, st):
        loss, grads = jax.value_and_grad(loss_fn)(lo)
        updates, st = tx.update(grads, st, lo)
        return optax.apply_updates(lo, updates), st, loss, grads

    lora = jax.tree_util.tree_map(jnp.asarray, lora_np)
    st = tx.init(lora)
    lora1, st, loss1, grads = step(lora, st)
    _, _, loss2, _ = step(lora1, st)
    got_losses, got, moments = _port_run(params, lora_np, data, 2)
    np.testing.assert_allclose(got_losses, [float(loss1), float(loss2)], rtol=1e-5)
    # The clip scales every gradient alike; the JAX grads are before it.
    norm = np.sqrt(sum(float(jnp.sum(g ** 2)) for g in jax.tree_util.tree_leaves(grads)))
    scale = min(1.0, 1.0 / norm)
    _assert_grads_close({n: {k: v / 0.1 / scale for k, v in ab.items()}
                         for n, ab in moments.items()}, grads)
    _assert_first_adam_step_close(got, lora1, grads)


def test_microbatch_accumulation_matches_the_whole_batch(case):
    params, lora_np, data = case
    whole_losses, whole, whole_mu = _port_run(params, lora_np, data, 1)
    micro_losses, micro, micro_mu = _port_run(params, lora_np, data, 1, microbatch=2)
    np.testing.assert_allclose(micro_losses, whole_losses, rtol=1e-6)
    _assert_grads_close(micro_mu, whole_mu)
    _assert_first_adam_step_close(micro, whole, whole_mu)


def test_stacked_members_match_each_member_alone(case):
    """Two LoRA members stacked in one `members_step` (the frozen base shared,
    a tree, an optimizer state and draws each; one member's factors 10x the
    other's, its gradient norm about 200x, so that only it is clipped)
    against each member
    stepped alone, the trainer's loop before it stacked them: losses within
    1e-6 relative, first moments within 1e-4 of each leaf's largest entry,
    the leaves after two steps within 1e-6 (float noise of a gradient in that
    band around 0 may move Adam's step up to 2 lr, which such elements are
    held to)."""
    params, lora_np, data = case
    other = dict(data, idx=np.array([1, 2, 9, 9]), t=np.array([40, 3, 870, 501]),
                 noise=np.random.default_rng(22).standard_normal((4, 8, 8, 4)).astype(np.float32))
    loud = jax.tree_util.tree_map(lambda a: np.asarray(a) * 10, _lora_tree(params, 23))
    stacked = _port_members(params, [lora_np, loud], [data, other], 2)
    for m, (lo, d) in enumerate(((lora_np, data), (loud, other))):
        alone = _port_members(params, [lo], [d], 2)
        np.testing.assert_allclose(stacked[0][:, m], alone[0][:, 0], rtol=1e-6)
        got_mu = lora_tree_to_jax(unstack_lora_tree(stacked[2], m))
        want_mu = lora_tree_to_jax(unstack_lora_tree(alone[2], 0))
        _assert_grads_close(got_mu, want_mu)
        _assert_first_adam_step_close(lora_tree_to_jax(unstack_lora_tree(stacked[1], m)),
                                      lora_tree_to_jax(unstack_lora_tree(alone[1], 0)), want_mu)


def test_sample_loop_with_a_text_context_matches_jax(case):
    params, _, _ = case
    model = JaxUNet2D(SPEC)
    spec = JaxSchedulerSpec(kind="ddim")
    ehs = np.random.default_rng(22).standard_normal((2, 6, 32)).astype(np.float32)
    shape, key = (2, 8, 8, 4), jax.random.PRNGKey(23)
    want = np.asarray(jax.jit(lambda k: jax_sample_loop(
        model.apply, params, jax_make_schedule(spec), spec, shape, k, num_inference_steps=3,
        kind="ddim", encoder_hidden_states=jnp.asarray(ehs)))(key))
    noise = np.asarray(jax.random.normal(jax.random.split(key)[0], shape, dtype=jnp.float32))
    port_spec = SchedulerSpec(kind="ddim")
    got = sample_loop(_port_unet(params), make_schedule(port_spec), port_spec, (2, 4, 8, 8),
                      device="cpu", init_noise=_nchw(noise), num_inference_steps=3,
                      encoder_hidden_states=torch.from_numpy(ehs))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-4, rtol=0)


def test_cli_flags_and_defaults_match_the_jax_clis():
    argv = ["--outdir", "o"]
    port = vars(train_text_to_image_lora.parse_args(argv))
    want = vars(jax_train_cli.parse_args(argv))
    assert port.pop("device") == "cuda" and want.pop("mesh_ensemble") is None
    assert port == want
    argv = ["--lora_dir", "a.npz", "--save_path", "b.npz"]
    assert vars(prune_lora.parse_args(argv)) == vars(jax_prune_cli.parse_args(argv))
    argv = ["--sample_outdir", "s"]
    port = vars(generate_samples_tti.parse_args(argv))
    assert port.pop("device") == "cuda"
    assert port == vars(jax_generate_cli.parse_args(argv))


def _fast(cls, seed):
    """`cls` whose init returns `_draw`n parameters of its shapes, and whose
    apply is one compiled program: the JAX CLIs' flax inits and the text
    tower's apply run op by op outside jit (about 20 s an init on this CPU).
    What this test compares (splits, rows, files) depends on no weight."""

    class Fast(cls):
        def init(self, *args, **kwargs):
            shapes = jax.eval_shape(lambda *a: cls.init(self, *a, **kwargs), *args)
            return {"params": _draw(shapes["params"], seed)}

        def apply(self, *args, **kwargs):
            return jax.jit(lambda *a: cls.apply(self, *a, **kwargs))(*args)

    Fast.__name__ = cls.__name__
    return Fast


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX CLIs once: 2 datamodel members x 1 step, then prune_lora on the
    first member."""
    out = str(tmp_path_factory.mktemp("jax_tti"))
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_train_cli, "UNet2D", _fast(JaxUNet2D, 30))
    mp.setattr(jax_train_cli, "CLIPTextEncoder", _fast(jax_clip.CLIPTextEncoder, 31))
    try:
        jax_train_cli.main(["--dataset", DATASET, "--outdir", out, "--removal_dist",
                            "datamodel", "--num_seeds", "2", "--max_train_steps", "1",
                            "--train_batch_size", "8", "--rank", "2"])
    finally:
        mp.undo()
    rows = list(jsonl.read_records(os.path.join(out, f"{DATASET}_lora_db.jsonl")))
    pruned = os.path.join(out, "pruned", "lora_weights.npz")
    jax_prune_cli.main(["--lora_dir", rows[0]["lora_path"], "--pruning_ratio", "0.4",
                        "--save_path", pruned])
    return out, rows, pruned


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_the_three_clis_end_to_end_beside_the_jax_clis(jax_run, tmp_path):
    jax_out, jax_rows, jax_pruned = jax_run
    out = str(tmp_path / "port")
    argv = ["--dataset", DATASET, "--outdir", out, "--removal_dist", "datamodel",
            "--num_seeds", "2", "--max_train_steps", "1", "--train_batch_size", "8",
            "--rank", "2", "--device", "cpu"]
    r = train_text_to_image_lora.main(argv)
    assert r["seeds"] == [0, 1] and r["batch"] == 8 and r["latents_cached"] is None
    assert all(np.isfinite(r["losses"]))
    rows = list(jsonl.read_records(r["db"]))
    assert len(rows) == len(jax_rows) == 2
    for row, jax_row in zip(rows, jax_rows):
        assert set(jax_row) - {"mesh_ensemble"} == set(row) - {"device"}
        for key in ("removal_seed", "remaining_idx", "removed_idx", "kept_units",
                    "lora_params"):
            assert row[key] == jax_row[key], key
    models = os.path.join("seed42", f"{DATASET}_post_impressionism", "retrain", "models")
    assert _tree_files(os.path.join(out, models)) == _tree_files(os.path.join(jax_out, models))
    for seed in (0, 1):
        leaf = os.path.join(models, f"datamodel_seed={seed}", "removal_idx.csv")
        with open(os.path.join(out, leaf)) as a, open(os.path.join(jax_out, leaf)) as b:
            assert a.read() == b.read()
    # Idempotence: every member exists, nothing to do.
    assert train_text_to_image_lora.main(argv)["seeds"] == []

    # prune_lora on the JAX member: the same info.csv and npz.
    pruned = str(tmp_path / "pruned" / "lora_weights.npz")
    p = prune_lora.main(["--lora_dir", jax_rows[0]["lora_path"], "--pruning_ratio", "0.4",
                         "--save_path", pruned])
    with open(p["info"]) as a, open(os.path.join(os.path.dirname(jax_pruned), "info.csv")) as b:
        assert a.read() == b.read()
    with np.load(pruned) as a, np.load(jax_pruned) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])

    # Sparse fine-tuning of the pruned LoRA keeps its heterogeneous ranks.
    ft = train_text_to_image_lora.main(argv[:6] + [
        "--num_seeds", "1", "--max_train_steps", "2", "--train_batch_size", "8", "--method",
        "pruned_ft", "--lora_dir", pruned, "--microbatch", "4", "--device", "cpu"])
    ranks = lora_ranks(load_lora_npz(ft["lora_paths"][0]))
    assert ranks == p["ranks"] and len(set(ranks.values())) > 1

    # Prompt samples from the member's LoRA, PNG per style, resumable.
    samples = str(tmp_path / "samples")
    gen = ["--dataset", DATASET, "--lora_dir", r["lora_paths"][0], "--sample_outdir", samples,
           "--styles", "post_impressionism", "baroque", "--n_samples_per_style", "3",
           "--batch_size", "2", "--num_inference_steps", "2", "--device", "cpu"]
    g = generate_samples_tti.main(gen)
    assert sorted(os.path.relpath(p_, samples) for p_ in g["written"]) == [
        os.path.join(style, f"{style}_{i:05d}.png")
        for style in ("baroque", "post_impressionism") for i in range(3)]
    assert generate_samples_tti.main(gen)["written"] == []


@pytest.mark.parametrize("extra,leaf", [
    (["--removal_dist", "counterfactual", "--masked_proportion", "0.3", "--direction",
      "bottom", "--num_seeds", "2"], "counterfactual_bottom_0.3"),
    (["--removal_dist", "uniform", "--removal_unit", "filename"], "uniform_seed=0"),
])
def test_counterfactual_and_filename_removal(tmp_path, extra, leaf):
    """Counterfactual removal drops the ranking's bottom units (one member
    whatever --num_seeds says); filename units train with one caption per
    artist (the JAX CLI raises there, ROADMAP C3)."""
    from group_attribution_for_diffusion_models_tpu.data import groups as jax_groups
    from group_attribution_for_diffusion_models_tpu_torch.data import create_dataset

    ranking = np.random.default_rng(24).permutation(10)
    np.save(tmp_path / "rank.npy", ranking)
    r = train_text_to_image_lora.main([
        "--dataset", DATASET, "--outdir", str(tmp_path), "--max_train_steps", "1",
        "--train_batch_size", "4", "--rank", "2", "--rank_file", str(tmp_path / "rank.npy"),
        "--device", "cpu"] + extra)
    assert len(r["lora_paths"]) == 1 and os.path.basename(os.path.dirname(
        r["lora_paths"][0])) == leaf
    removed = np.loadtxt(os.path.join(os.path.dirname(r["lora_paths"][0]), "removal_idx.csv"),
                         skiprows=1, dtype=np.int64, ndmin=1)
    if extra[1] == "counterfactual":
        files = [f"artist-{lab}_work_{i}.jpg"
                 for i, lab in enumerate(create_dataset(DATASET).labels)]
        units = sorted({jax_groups.artist_from_filename(f) for f in files})
        _, want = jax_groups.counterfactual_split(files, units, ranking, 0.3, "bottom")
        np.testing.assert_array_equal(removed, want)
    assert np.isfinite(r["losses"]).all()


def test_pretrained_tower_flags(tmp_path):
    """--unet_ckpt reads the port's checkpoint format and --text_encoder_weights
    the JAX package's .npz, which needs --tokenizer_dir (the CLIP BPE)."""
    from group_attribution_for_diffusion_models_tpu_torch.models import build_unet
    from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import save_checkpoint
    from test_clip_tokenizer import _write_tiny_vocab
    from test_torch_tti import _clip_params

    sd = build_unet(train_text_to_image_lora.tiny_sd_spec(8), seed=3).state_dict()
    save_checkpoint(str(tmp_path / "base"), 0, sd, sd)
    _, params = _clip_params(25)
    np.savez(tmp_path / "clip.npz", **{"/".join(k.key for k in p): np.asarray(v)
                                       for p, v in jax.tree_util.tree_flatten_with_path(params)[0]})
    vocab = str(_write_tiny_vocab(tmp_path / "vocab"))

    def pngs(out, *flags):
        g = generate_samples_tti.main(["--dataset", DATASET, "--sample_outdir",
                                       str(tmp_path / out), "--n_samples_per_style", "2",
                                       "--batch_size", "2", "--num_inference_steps", "2",
                                       "--device", "cpu", *flags])
        return [open(p, "rb").read() for p in g["written"]]

    with pytest.raises(SystemExit):
        pngs("no_vocab", "--text_encoder_weights", str(tmp_path / "clip.npz"))
    random_base = pngs("random")
    pretrained = ["--unet_ckpt", str(tmp_path / "base"), "--text_encoder_weights",
                  str(tmp_path / "clip.npz"), "--tokenizer_dir", vocab]
    a, b = pngs("a", *pretrained), pngs("b", *pretrained)
    assert a == b and a != random_base
    assert pngs("base_only", *pretrained[:2]) not in (a, random_base)
