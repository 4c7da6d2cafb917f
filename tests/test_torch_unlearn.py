"""The port's WoodFisher unlearning and `cli.unlearn` against the JAX
package's, on the CPU.

JAX draws each batch's timesteps and noise from threefry keys of its `seed`,
which torch cannot reproduce, so the tests compute those draws with JAX, as
the JAX functions do, and inject them into the port. One JAX
`influence_unlearn` run on a tiny U-Net (2 levels of 32 channels, a mid
attention) is shared by the module, its `average_gradient` and
`woodfisher_inv_hvp` calls recorded (each JAX call compiles for seconds).
Flat vectors cross between packages through the weight bridge: the JAX
functions ravel `tree_leaves`, the port `named_parameters`.

Tolerances: a mean gradient within GRAD_RTOL of its largest entry (float32
convolutions summed in other orders); the WoodFisher change k - v and the
whole perturbation within WF_RTOL in L2 norm (the recursion multiplies
those gradients through dot products of 70k-entry vectors in float32);
`apply_perturbation` of the same delta bit for bit; the rank-1 recursion in
float32 against a dense float64 evaluation of the same formula, rtol 1e-5
in L2.

`cli.unlearn` for iu, gd, ga and lora: rows with the JAX CLI's keys, less
LEFT_OUT, and its removal indices bit for bit (the JAX CLI runs with its
flax init swapped for drawn parameters and its training replaced by a
no-op: the row depends on no weight); ga raises the loss on the removed
set; the LoRA merge leaves every other weight bit for bit as it was.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from group_attribution_for_diffusion_models_tpu.cli import common as jax_common
from group_attribution_for_diffusion_models_tpu.cli import unlearn as jax_unlearn
from group_attribution_for_diffusion_models_tpu.config.registry import (
    SchedulerSpec as JaxSchedulerSpec,
)
from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import (
    antithetic_timesteps as jax_antithetic,
)
from group_attribution_for_diffusion_models_tpu.diffusion.schedulers import (
    make_schedule as jax_make_schedule,
)
from group_attribution_for_diffusion_models_tpu.models import UNet2D as JaxUNet2D
from group_attribution_for_diffusion_models_tpu.training import state as jax_state
from group_attribution_for_diffusion_models_tpu.unlearn import woodfisher as jax_wf
from group_attribution_for_diffusion_models_tpu.utils import read_records as jax_read_records
from group_attribution_for_diffusion_models_tpu.utils.ckpt import (
    save_checkpoint as jax_save_checkpoint,
)
from group_attribution_for_diffusion_models_tpu_torch.cli import unlearn as unlearn_cli
from group_attribution_for_diffusion_models_tpu_torch.cli.common import config_for
from group_attribution_for_diffusion_models_tpu_torch.config.registry import SchedulerSpec
from group_attribution_for_diffusion_models_tpu_torch.data import create_dataset
from group_attribution_for_diffusion_models_tpu_torch.diffusion import add_noise, make_schedule
from group_attribution_for_diffusion_models_tpu_torch.models import (
    SelfAttention2D,
    UNet2D,
    params_from_jax,
)
from group_attribution_for_diffusion_models_tpu_torch.models.lora import target_modules
from group_attribution_for_diffusion_models_tpu_torch.ops import group_norm_silu
from group_attribution_for_diffusion_models_tpu_torch.unlearn import (
    apply_perturbation,
    average_gradient,
    influence_unlearn,
    woodfisher_inv_hvp,
    woodfisher_recursion,
)
from group_attribution_for_diffusion_models_tpu_torch.utils.ckpt import save_checkpoint
from group_attribution_for_diffusion_models_tpu_torch.utils.jsonl import read_records
from test_torch_main_cli import _no_step
from test_torch_tti_cli import _fast
from test_torch_unet import _jax_params, _port_spec, _variant

GRAD_RTOL, WF_RTOL = 1e-4, 1e-3
DATASET = "synthetic_64x8_big"  # a U-Net with attention: LoRA has its targets
LEFT_OUT = {"profile_dir"}  # the JAX common flag no port job reads (ROADMAP A item 9)
SEED, ALPHA, BATCH, WF_BATCHES = 7, 0.5, 8, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec():
    return dataclasses.replace(_variant("synthetic_32x8"), block_out_channels=(32, 32),
                               norm_num_groups=8)


def _jax_draws(key, images):
    """(timesteps, noise NCHW) of one batch, as JAX `_batch_grad_fn` draws them."""
    k_t, k_n = jax.random.split(key)
    t = jax_antithetic(k_t, images.shape[0], JaxSchedulerSpec().num_train_timesteps)
    noise = jax.random.normal(k_n, images.shape)
    return torch.tensor(np.asarray(t)).long(), torch.tensor(np.asarray(noise)).permute(0, 3, 1, 2)


def _avg_draws(images, batch_size, seed):
    n = len(images)
    key, out = jax.random.PRNGKey(seed), []
    for i in range(0, n - n % batch_size or n, batch_size):
        key, sub = jax.random.split(key)
        out.append(_jax_draws(sub, images[i:i + batch_size]))
    return out


def _wf_draws(images, num_batches, batch_size, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), num_batches)
    return [_jax_draws(k, images[j * batch_size:(j + 1) * batch_size])
            for j, k in enumerate(keys)]


@pytest.fixture(scope="module")
def ref():
    """One JAX influence_unlearn run, its parts recorded; the port's model
    with the same weights."""
    spec = _spec()
    params = _jax_params(spec, 13)
    rng = np.random.default_rng(14)
    removed = rng.uniform(-1, 1, (20, 8, 8, 3)).astype(np.float32)
    remaining = rng.uniform(-1, 1, (36, 8, 8, 3)).astype(np.float32)
    calls = {"avg": [], "wf": []}
    real_avg, real_wf = jax_wf.average_gradient, jax_wf.woodfisher_inv_hvp
    real_grad_fn, grad_fns = jax_wf._batch_grad_fn, {}
    mp = pytest.MonkeyPatch()
    # One batch-gradient function for both average gradients, so jax.jit
    # compiles it once (the JAX function builds a new one a call).
    mp.setattr(jax_wf, "_batch_grad_fn", lambda *a: grad_fns.setdefault(
        tuple(map(id, a)), real_grad_fn(*a)))
    mp.setattr(jax_wf, "average_gradient",
               lambda *a, **k: calls["avg"].append(np.asarray(real_avg(*a, **k)))
               or calls["avg"][-1])
    mp.setattr(jax_wf, "woodfisher_inv_hvp",
               lambda *a, **k: calls["wf"].append((np.asarray(a[5]), np.asarray(real_wf(*a, **k))))
               or calls["wf"][-1][1])
    try:
        new = jax_wf.influence_unlearn(
            JaxUNet2D(spec).apply, params, jax_make_schedule(JaxSchedulerSpec()),
            JaxSchedulerSpec(), removed, remaining, alpha=ALPHA, batch_size=BATCH,
            wf_batches=WF_BATCHES, seed=SEED)
    finally:
        mp.undo()
    model = UNet2D(_port_spec(spec))
    model.load_state_dict(params_from_jax(params))
    meta = jax_wf._flatten(params)[1]

    def to_port(flat):
        sd = params_from_jax(jax.tree_util.tree_map(
            np.asarray, jax_wf._unflatten(jnp.asarray(flat), meta)))
        return torch.cat([sd[n].reshape(-1) for n, _ in model.named_parameters()])

    return {"spec": spec, "params": params, "model": model, "removed": removed,
            "remaining": remaining, "calls": calls, "to_port": to_port,
            "new": params_from_jax(jax.tree_util.tree_map(np.asarray, new)),
            "schedule": make_schedule(SchedulerSpec())}


def test_average_gradient_matches_jax(ref):
    for images, seed, want in ((ref["removed"], SEED, ref["calls"]["avg"][0]),
                               (ref["remaining"], SEED + 1, ref["calls"]["avg"][1])):
        got = average_gradient(ref["model"], ref["schedule"], SchedulerSpec(), images, BATCH,
                               seed, draws=_avg_draws(images, BATCH, seed))
        want = ref["to_port"](want)
        assert got.shape == want.shape and got.dtype == torch.float32
        err = (got - want).abs().max().item()
        assert err <= GRAD_RTOL * want.abs().max().item(), err


def test_woodfisher_inv_hvp_matches_jax(ref):
    direction, want = ref["calls"]["wf"][0]
    images = ref["remaining"]
    v = ref["to_port"](direction)
    got = woodfisher_inv_hvp(ref["model"], ref["schedule"], SchedulerSpec(), images, v,
                             num_batches=WF_BATCHES, batch_size=BATCH // 4,
                             draws=_wf_draws(images, WF_BATCHES, BATCH // 4, SEED + 2))
    want = ref["to_port"](want)
    change, want_change = got - v, want - v
    rel = (torch.linalg.vector_norm(change - want_change)
           / torch.linalg.vector_norm(want_change)).item()
    assert torch.linalg.vector_norm(want_change) > 1e-3 * torch.linalg.vector_norm(v)
    assert rel <= WF_RTOL, rel


def test_apply_perturbation_is_the_jax_sum_bit_for_bit(ref):
    delta = ref["to_port"](ref["calls"]["wf"][0][1])
    got = apply_perturbation(ref["model"], delta, ALPHA)
    assert set(got) == set(ref["new"])
    for n, w in ref["new"].items():
        assert torch.equal(got[n], w), n
    with pytest.raises(ValueError, match="delta of"):
        apply_perturbation(ref["model"], delta[:-1])


def test_influence_unlearn_matches_jax(ref):
    removed, remaining = ref["removed"], ref["remaining"]
    draws = {"removed": _avg_draws(removed, BATCH, SEED),
             "remaining": _avg_draws(remaining, BATCH, SEED + 1),
             "woodfisher": _wf_draws(remaining, WF_BATCHES, BATCH // 4, SEED + 2)}
    seconds = {}
    got = influence_unlearn(ref["model"], ref["schedule"], SchedulerSpec(), removed, remaining,
                            alpha=ALPHA, batch_size=BATCH, wf_batches=WF_BATCHES, seed=SEED,
                            draws=draws, seconds=seconds)
    assert set(seconds) == {"g_removed", "g_remaining", "woodfisher"}
    old = dict(ref["model"].named_parameters())
    moved = torch.cat([(got[n] - old[n].detach()).reshape(-1) for n in old])
    want = torch.cat([(ref["new"][n] - old[n].detach()).reshape(-1) for n in old])
    rel = (torch.linalg.vector_norm(moved - want) / torch.linalg.vector_norm(want)).item()
    assert rel <= WF_RTOL, rel
    # The port's own draws: one seed, one result; another seed, another.
    a, b, c = (influence_unlearn(ref["model"], ref["schedule"], SchedulerSpec(), removed,
                                 remaining, batch_size=BATCH, wf_batches=2, seed=s)
               for s in (1, 1, 2))
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert any(not torch.equal(a[n], c[n]) for n in a)


def test_woodfisher_recursion_against_a_dense_evaluation():
    """k = prod_i (I - o_{i-1} g_i^T / (n + o_{i-1}.g_i + damping)) v with
    o_0 = g_0 and o_i = o_{i-1} (1 - (o_{i-1}.g_i) / (n + o_{i-1}.g_i +
    damping)), as D x D matrices in float64."""
    rng = np.random.default_rng(0)
    d, n, damping = 48, 30.0, 1e-4
    v = rng.standard_normal(d)
    grads = rng.standard_normal((6, d))
    k, o = v.copy(), grads[0].copy()
    for g in grads[1:]:
        tmp = o @ g
        denom = n + tmp + damping
        k = (np.eye(d) - np.outer(o, g) / denom) @ k
        o = o * (1.0 - tmp / denom)
    got = woodfisher_recursion(torch.tensor(v, dtype=torch.float32),
                               (torch.tensor(g, dtype=torch.float32) for g in grads), n, damping)
    np.testing.assert_allclose(np.linalg.norm(got.numpy() - k) / np.linalg.norm(k), 0, atol=1e-5)
    # One gradient only sets o: k is v.
    one = woodfisher_recursion(torch.ones(3), iter([torch.arange(3.0)]), n)
    assert torch.equal(one, torch.ones(3))


def test_woodfisher_needs_a_full_batch(ref):
    with pytest.raises(ValueError, match="not enough data"):
        woodfisher_inv_hvp(ref["model"], ref["schedule"], SchedulerSpec(), ref["removed"][:3],
                           torch.zeros(1), batch_size=4)


# --- cli.unlearn -------------------------------------------------------------


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """The same drawn full model saved by both packages."""
    root = tmp_path_factory.mktemp("unlearn")
    spec = jax_common.config_for(DATASET).unet
    params = _jax_params(spec, 17)
    jax_dir, port_dir = str(root / "jax_full"), str(root / "port_full")
    tx = jax_state.make_optimizer("adam", lr=1e-4)
    jax_save_checkpoint(jax_dir, 1, jax_state.TrainState.create(params, tx), unet_spec=spec)
    sd = params_from_jax(params)
    save_checkpoint(port_dir, 1, sd, sd, unet_spec=config_for(DATASET).unet)
    return {"root": root, "jax": jax_dir, "port": port_dir, "params": sd}


def _argv(method, load, outdir, *extra):
    return ["--dataset", DATASET, "--method", method, "--load", load, "--outdir", outdir,
            "--removal_dist", "shapley", "--removal_seed", "1", "--by_class",
            "--training_steps", "2", "--batch_size", "8", "--wf_batches", "2",
            "--lora_rank", "4", *extra]


@pytest.mark.parametrize("method", ["iu", "gd", "ga", "lora"])
def test_cli_rows_have_the_jax_keys_and_removal(loaded, method, monkeypatch):
    outdir = str(loaded["root"] / method)
    monkeypatch.setattr(jax_unlearn, "UNet2D", _fast(JaxUNet2D, 18))
    monkeypatch.setattr(jax_unlearn, "influence_unlearn", lambda apply_fn, params, *a, **k: params)
    monkeypatch.setattr(jax_unlearn, "make_train_step", _no_step)
    monkeypatch.setattr(jax_unlearn, "lora_init", lambda params, **k: {})
    jax_db, db = os.path.join(outdir, "jax.jsonl"), os.path.join(outdir, "port.jsonl")
    jax_unlearn.main(_argv(method, loaded["jax"], outdir, "--model_behavior", "none",
                           "--db", jax_db))
    out = unlearn_cli.main(_argv(method, loaded["port"], outdir, "--model_behavior", "none",
                                 "--db", db, "--device", "cpu"))
    (want,) = list(jax_read_records(jax_db))
    (got,) = list(read_records(db))
    assert set(got) - {"device"} == set(want) - LEFT_OUT
    assert got["remaining_idx"] == want["remaining_idx"]
    assert got["removed_idx"] == want["removed_idx"]
    assert got["unlearn_time"] > 0 and got["sampling_time"] == 0.0
    assert (out["iu_seconds"] is not None) == (method == "iu")
    assert all(torch.isfinite(v).all() for v in out["state_dict"].values())


def _loss(state_dict, images, seed=3):
    """The epsilon MSE of `state_dict` on `images` with fixed draws."""
    model = UNet2D(config_for(DATASET).unet)
    model.load_state_dict(state_dict)
    gen = torch.Generator().manual_seed(seed)
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    t = torch.randint(0, 1000, (len(x),), generator=gen)
    noise = torch.randn(x.shape, generator=gen)
    with torch.no_grad():
        eps = model(add_noise(make_schedule(SchedulerSpec()), x, noise, t), t)
    return torch.mean((eps - noise) ** 2).item()


def test_ga_raises_the_loss_on_the_removed_set(loaded):
    out = unlearn_cli.main(_argv("ga", loaded["port"], str(loaded["root"] / "ga_loss"),
                                 "--model_behavior", "local", "--n_samples", "2",
                                 "--num_inference_steps", "2", "--training_steps", "4",
                                 "--device", "cpu"))
    removed = create_dataset(DATASET).images[out["row"]["removed_idx"]]
    assert _loss(out["state_dict"], removed) > _loss(loaded["params"], removed)
    scores = out["scores"]
    assert set(scores) == {"avg_mse", "avg_nrmse", "avg_ssim"}
    assert scores["avg_mse"] > 0 and -1 <= scores["avg_ssim"] < 1


def test_lora_merge_leaves_other_weights_bit_for_bit(loaded):
    sums = group_norm_silu.affine_sums
    out = unlearn_cli.main(_argv("lora", loaded["port"], str(loaded["root"] / "lora_merge"),
                                 "--model_behavior", "local", "--n_samples", "2",
                                 "--num_inference_steps", "2", "--device", "cpu"))
    assert group_norm_silu.affine_sums == sums  # the frozen base's gamma/beta: no reduction
    model = UNet2D(config_for(DATASET).unet)
    targets = {f"{name}.weight" for name, _ in target_modules(model)}
    # SelfAttention2D's to_q, to_k, to_v and to_out.0 are the LoRA targets.
    assert len(targets) == 4 * sum(isinstance(m, SelfAttention2D) for m in model.modules()) > 0
    sd, base = out["state_dict"], loaded["params"]
    assert set(sd) == set(base)
    for n, w in base.items():
        if n in targets:
            assert not torch.equal(sd[n], w), n
        else:
            assert torch.equal(sd[n], w), n

