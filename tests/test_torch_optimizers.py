"""The text-to-image leftovers of the optimizer and LoRA modules, against
the JAX package, on the CPU.

* 8-bit Adam (`training.quantized`) against JAX ``adam8bit`` and Adafactor
  against ``optax.adafactor``, both inside `make_optimizer`'s chain (the
  global-norm clip first), over 4 steps on tensors of several shapes (a
  padded last block, factored and unfactored ones). Adafactor: each
  tensor's move within 1e-4 of its largest element. 8-bit Adam: 99.9% of
  the elements within 1e-5 of the largest move, every element within 2%
  (round() of a first-moment code can land on the other side of a .5 in
  the two packages' f32 arithmetic: one code of 127 is 0.8% of a move).
* The stacked path (a leading member axis of 3) against ``jax.vmap`` of
  the JAX update over members, and against each member updated alone; a
  block never spans two members. The stacked U-Net step (`make_members_step`
  on an `EnsembleState`) with each optimizer against its members stepped
  alone; a checkpoint saves and restores each optimizer's state.
* `lora_plus_optimizer` against the JAX LoRA+ transformation over 3 steps
  (constant and cosine; atol 1e-7), and LoRA safetensors files that each
  package writes and the other reads, bit for bit; without the
  ``safetensors`` package the call fails naming it.
* `cli.create_metadata`'s CSVs against the JAX CLI's, byte for byte.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from group_attribution_for_diffusion_models_tpu.cli import create_metadata as jax_metadata
from group_attribution_for_diffusion_models_tpu.models import lora as jax_lora
from group_attribution_for_diffusion_models_tpu.training import state as jax_state
from group_attribution_for_diffusion_models_tpu_torch.cli import common as port_common
from group_attribution_for_diffusion_models_tpu_torch.cli import create_metadata
from group_attribution_for_diffusion_models_tpu_torch.diffusion import make_schedule
from group_attribution_for_diffusion_models_tpu_torch.models import build_unet
from group_attribution_for_diffusion_models_tpu_torch.models.lora import (
    load_lora_safetensors,
    lora_init,
    lora_plus_optimizer,
    save_lora_safetensors,
)
from group_attribution_for_diffusion_models_tpu_torch.training import (
    TrainState,
    init_ensemble_state,
    make_members_step,
    make_optimizer,
    make_train_step,
    unstack_state,
)
from group_attribution_for_diffusion_models_tpu_torch.training.quantized import (
    BLOCK,
    dequantize,
)
from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import (
    resume_or_init,
    save_checkpoint,
)

SHAPES = [(130, 200), (160, 129, 3, 3), (64,), (3000,), (5, 7)]
LR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check(name, got, want, start):
    """Each tensor's move against the JAX move (the module docstring's
    tolerances)."""
    for g, w, s in zip(got, want, start):
        g, w = g.numpy(), np.asarray(w)
        scale = np.abs(w - s).max()
        err = np.abs(g - w)
        if name == "adafactor":
            assert err.max() <= 1e-4 * scale
        else:
            assert (err <= 1e-5 * scale).mean() >= 0.999 and err.max() <= 0.02 * scale


def _draws(rng, shapes, steps):
    return [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(steps)]


@pytest.mark.parametrize("name", ["adafactor", "adam8bit"])
def test_optimizer_matches_jax_over_steps(name):
    rng = np.random.default_rng(0)
    start = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in SHAPES]
    tx = jax_state.make_optimizer(name, lr=LR)
    jp = [jnp.asarray(p) for p in start]
    jst = tx.init(jp)
    update = jax.jit(tx.update)
    port = make_optimizer(name, lr=LR)
    tp = [torch.from_numpy(p.copy()) for p in start]
    pst = port.init(tp)
    for grads in _draws(rng, SHAPES, 4):
        updates, jst = update([jnp.asarray(g) for g in grads], jst, jp)
        jp = optax.apply_updates(jp, updates)
        norm = port.update([torch.from_numpy(g.copy()) for g in grads], pst, tp)
        assert norm is not None  # the chain's clip ran first
    _check(name, tp, jp, start)
    assert pst.count == 4
    if name == "adam8bit":
        # The first moment's codes: within one code of the JAX state's.
        (jmu,) = [s for s in jst if hasattr(s, "mu")]
        for q, s, jm in zip(pst.mu_q, pst.mu_scale, jmu.mu):
            assert q.shape == jm.q.shape and q.dtype == torch.int8
            diff = np.abs(dequantize(q, s).numpy() - np.asarray(jm.q, np.float32)
                          * np.asarray(jm.scales))
            assert (diff <= 1.01 * s.numpy()).all()


@pytest.mark.parametrize("name", ["adafactor", "adam8bit"])
def test_stacked_members_match_jax_vmap_and_each_member_alone(name):
    """3 members: the port's update with a member axis against jax.vmap of
    the JAX chain, and against each member's own update."""
    members, shapes = 3, [(1000,), (130, 200), (160, 129, 3, 3)]
    rng = np.random.default_rng(1)
    start = [rng.standard_normal((members,) + s).astype(np.float32) * 0.1 for s in shapes]
    tx = jax_state.make_optimizer(name, lr=LR)
    jp = [jnp.asarray(p) for p in start]
    jst = jax.vmap(tx.init)(jp)
    update = jax.jit(jax.vmap(tx.update))
    port = make_optimizer(name, lr=LR)
    tp = [torch.from_numpy(p.copy()) for p in start]
    pst = port.init(tp, members=members)
    alone = [[torch.from_numpy(p[m].copy()) for p in start] for m in range(members)]
    alone_st = [port.init(a) for a in alone]
    if name == "adam8bit":  # (1000,) is one padded block a member, never shared
        assert tuple(pst.mu_q[0].shape) == (members, 1, BLOCK)
    for grads in _draws(rng, [(members,) + s for s in shapes], 3):
        u, jst = update([jnp.asarray(g) for g in grads], jst, jp)
        jp = optax.apply_updates(jp, u)
        norms = port.update([torch.from_numpy(g.copy()) for g in grads], pst, tp,
                            members=members)
        assert norms.shape == (members,)
        for m in range(members):
            port.update([torch.from_numpy(g[m].copy()) for g in grads], alone_st[m], alone[m])
    _check(name, tp, jp, start)
    for m in range(members):
        for t, a in zip(tp, alone[m]):
            torch.testing.assert_close(t[m], a, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["adafactor", "adam8bit"])
def test_stacked_unet_step_and_checkpoint(tmp_path, name):
    """Two stacked synthetic U-Nets, one step on injected draws, against each
    member's own step (each tensor's move within 1% of its L2 norm, as
    tests/test_torch_main_cli.py holds Adam: the vmapped convolutions sum in
    another order, and a first step of Adam turns float noise of a gradient
    near zero into a step of lr; the key biases, whose gradient is all float
    noise, are left out);
    then the optimizer state through a checkpoint and back, bit for bit."""
    cfg = port_common.config_for("synthetic_64x8")
    spec, sched = cfg.unet, cfg.scheduler
    tx = make_optimizer(name, lr=1e-3)
    state = init_ensemble_state(None, tx, 2, init_seeds=[3, 4],
                                init_fn=lambda s: build_unet(spec, s))
    start = {k: v.detach().clone() for k, v in state.params.items()}
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.uniform(-1, 1, (2, 4, 3, 8, 8)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((2, 4, 3, 8, 8)).astype(np.float32))
    t = torch.tensor([[1, 500, 900, 20], [7, 999, 0, 300]])
    schedule = make_schedule(sched)
    solo = [unstack_state(state, m) for m in range(2)]
    make_members_step(tx, schedule)(state, images, t, noise)
    step = make_train_step(tx, schedule, sched)
    for m, s in enumerate(solo):
        step(s, images[m], timesteps=t[m], noise=noise[m])
        for n, p in s.model.named_parameters():
            if n.endswith("to_k.bias"):
                # Its gradient is zero in exact arithmetic (a key bias shifts all
                # of a query's scores alike): the optimizers scale float noise.
                continue
            moved = torch.linalg.vector_norm(p.detach() - start[n][m])
            err = torch.linalg.vector_norm(state.params[n][m].detach() - p.detach())
            assert err <= 1e-2 * moved + 1e-8, (n, m)
    one = solo[0]
    params, ema = one.state_dicts()
    save_checkpoint(str(tmp_path), 1, params, ema, opt_state=one.opt_state)
    fresh = TrainState.create(build_unet(spec, 9), tx)
    back, _, resumed = resume_or_init(str(tmp_path), fresh)
    assert resumed and back.opt_state.count == one.opt_state.count == 1
    for slot, ts in one.opt_state.slots().items():
        for a, b in zip(ts, back.opt_state.slots()[slot]):
            assert torch.equal(a, b), slot


def test_make_optimizer_names():
    for name in ("adam", "adamw", "adafactor", "adam8bit"):
        assert make_optimizer(name).name == name
    with pytest.raises(ValueError, match="sgd"):
        make_optimizer("sgd")


def _lora_tree(seed):
    """A LoRA tree of the tiny conditional U-Net, both leaves drawn."""
    spec = port_common.config_for("synthetic_64x8_cond").unet
    tree = lora_init(build_unet(spec, 0), rank=4, generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    return {n: {"down": ab["down"], "up": torch.randn(ab["up"].shape, generator=gen) * 0.1}
            for n, ab in tree.items()}


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_lora_plus_matches_jax(schedule):
    from group_attribution_for_diffusion_models_tpu_torch.models.convert_diffusers import (
        lora_tree_to_jax,
    )

    tree = _lora_tree(5)
    kw = dict(plus_ratio=16.0, weight_decay=1e-2, lr_schedule=schedule, total_steps=4)
    jtx = jax_lora.lora_plus_optimizer(1e-3, **kw)
    jtree = jax.tree_util.tree_map(jnp.asarray, lora_tree_to_jax(tree))
    jst = jtx.init(jtree)
    port = lora_plus_optimizer(1e-3, **kw)
    pst = port.init(tree)
    rng = np.random.default_rng(6)
    for _ in range(3):
        grads = {n: {leaf: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
                     for leaf, v in ab.items()} for n, ab in tree.items()}
        u, jst = jtx.update(jax.tree_util.tree_map(jnp.asarray, lora_tree_to_jax(grads)), jst,
                            jtree)
        jtree = optax.apply_updates(jtree, u)
        port.update(grads, pst, tree)
    got = lora_tree_to_jax(tree)
    for name, ab in got.items():
        for leaf, v in ab.items():
            np.testing.assert_allclose(v, np.asarray(jtree[name][leaf]), atol=1e-7, rtol=0)


def test_lora_safetensors_cross_read(tmp_path, monkeypatch):
    tree = _lora_tree(7)
    port_file, jax_file = str(tmp_path / "port.safetensors"), str(tmp_path / "jax.safetensors")
    save_lora_safetensors(port_file, tree)
    from group_attribution_for_diffusion_models_tpu_torch.models.convert_diffusers import (
        lora_tree_to_jax,
    )

    jax_lora.save_lora_safetensors(jax_file, lora_tree_to_jax(tree))
    read_by_jax = jax_lora.load_lora_safetensors(port_file)
    for name, ab in lora_tree_to_jax(tree).items():
        for leaf, v in ab.items():
            np.testing.assert_array_equal(np.asarray(read_by_jax[name][leaf]), v)
    for file in (port_file, jax_file):
        back = load_lora_safetensors(file)
        assert back.keys() == tree.keys()
        for name, ab in tree.items():
            for leaf, v in ab.items():
                assert torch.equal(back[name][leaf], v), (file, name, leaf)
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    with pytest.raises(ImportError, match="needs the 'safetensors' package"):
        load_lora_safetensors(port_file)


def test_create_metadata_writes_the_jax_clis_csvs(tmp_path):
    images = tmp_path / "images"
    images.mkdir()
    for artist, n in (("claude-monet", 3), ("paul-cezanne", 2), ("berthe-morisot", 1)):
        for j in range(n):
            (images / f"{artist}_work-{j}_{1880 + j}.png").write_bytes(b"")
    (images / "notes.txt").write_text("not an image")
    argv = ["--image_dir", str(images), "--style", "impressionism", "--expected_count", "6"]
    jax_metadata.main(argv + ["--out_dir", str(tmp_path / "jax")])
    artists, filenames = create_metadata.main(argv + ["--out_dir", str(tmp_path / "port")])
    assert len(artists) == 3 and len(filenames) == 6
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n
    with pytest.raises(Exception):
        create_metadata.main(["--image_dir", str(images), "--style", "impressionism",
                              "--expected_count", "7", "--out_dir", str(tmp_path / "x")])
