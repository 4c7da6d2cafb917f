"""TRAK / D-TRAK gradient features and score assembly.

Port of the JAX package's ``attributions/methods/trak.py``. A feature is the
per-sample gradient of an output function of the U-Net's noise prediction,
averaged over timesteps, then projected by the JL kernel
(``ops/jl_projection.py``). The per-sample gradient is
``torch.func.vmap(torch.func.grad(f))`` over ``torch.func.functional_call``,
one batched call per timestep: the attention and GroupNorm Functions carry
`vmap` rules, so the forward and backward kernels run on the whole batch at
once (the JAX package's ``jax.vmap(jax.grad(f))``).

Each timestep's per-sample gradients are added, leaf by leaf and in place,
into one preallocated (B, D) float32 buffer; the leaves are never
concatenated (at B = 32, D = 35,746,307 the buffer alone is 4.6 GB). The
flattening order is the port's ``named_parameters`` order (the JAX package
uses ``tree_leaves`` order); with the JL stream, which is the port's own,
that makes a feature store one package's.

Output functions f over the prediction: 'loss' (the D-TRAK default, MSE
against the true noise), 'mean', 'mean-squared-l2-norm', 'l1-norm',
'l2-norm', 'linf-norm'. `compute_gradient_scores` and `aggregate_by_group`
are numpy, as in the JAX package.

The noise is injectable: a list with one (B, C, H, W) tensor per timestep
(or trajectory point), so tests give both packages the same draws; without
it, the noise is drawn from the caller's `torch.Generator`.

The text-to-image tier differentiates a LoRA alone, under text
conditioning (the JAX ``params_filter=(base, lora) -> lora_merge`` and
``conditional=True``): with `lora` the gradients are those of the LoRA
factors, attached as ``LoRADense``'s ``lora_down``/``lora_up`` buffers by
``functional_call`` (the side branch, numerically the merge) with the base
held fixed, and flattened in the JAX leaf order (JAX module paths sorted,
``down`` before ``up``); with `conditional` each sample brings its own
context (B, M, D), vmapped beside the latents.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, grad, vmap

from ...config.registry import SchedulerSpec
from ...diffusion.schedulers import ScheduleState, add_noise
from ...models.convert_diffusers import unet_jax_path
from ...ops.jl_projection import jl_project

OUTPUT_FNS = (
    "loss",
    "mean",
    "mean-squared-l2-norm",
    "l1-norm",
    "l2-norm",
    "linf-norm",
)


def _output_fn(name: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    if name == "loss":
        return lambda eps, noise: torch.mean((eps - noise) ** 2)
    if name == "mean":
        return lambda eps, noise: torch.mean(eps)
    if name == "mean-squared-l2-norm":
        return lambda eps, noise: torch.mean(eps**2)
    if name == "l1-norm":
        return lambda eps, noise: torch.sum(torch.abs(eps))
    if name == "l2-norm":
        return lambda eps, noise: torch.sqrt(torch.sum(eps**2))
    if name == "linf-norm":  # amax shares the gradient among ties, as jnp.max
        return lambda eps, noise: torch.amax(torch.abs(eps))
    raise ValueError(f"unknown output fn {name!r}; choose from {OUTPUT_FNS}")


def feature_timesteps(
    num_train_timesteps: int, num_timesteps: int, strategy: str = "uniform"
) -> np.ndarray:
    """Timestep grid for feature averaging (reference d_trak_grad.py:718-721)."""
    if strategy == "uniform":
        return np.arange(0, num_train_timesteps, num_train_timesteps // num_timesteps)[
            :num_timesteps
        ]
    if strategy == "cumulative":
        return np.arange(num_timesteps)
    raise ValueError(f"unknown t_strategy {strategy!r}")


class PerSampleGradients:
    """Per-sample gradients of ``f(model(x_t, t), noise)`` with respect to the
    model's parameters, flattened to (B, dim).

    `params_filter` (a list of parameter names, `models.lora.
    attention_params_filter`) restricts them to those parameters; with
    `sketch_probe` (`models.lora.probe_sketch_init`) the model runs with the
    probe as a zero-output LoRA side branch and only its `up` leaves are
    differentiated, so each row is the sketch down^T grad_kernel of every
    attention projection; with `lora` (a `models.lora` tree) the gradients
    are the LoRA factors', the base fixed, in the JAX leaf order. The three
    are exclusive. With `conditional` the model takes a per-sample context,
    a fifth vmapped argument of `accumulate`. `names` and `dim` give the
    flattening order and width."""

    def __init__(
        self,
        model: nn.Module,
        output_fn: str = "loss",
        params_filter: Optional[Sequence[str]] = None,
        sketch_probe: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
        lora: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
        conditional: bool = False,
    ):
        if sum(x is not None for x in (sketch_probe, params_filter, lora)) > 1:
            raise ValueError("sketch_probe, params_filter and lora are exclusive")
        self.model = model
        self.f = _output_fn(output_fn)
        params = {n: p.detach() for n, p in model.named_parameters()}
        if lora is not None:
            self.fixed = params
            self.trainable = {}
            for m in sorted(lora, key=lambda name: "/".join(unet_jax_path(name))):
                self.trainable[f"{m}.lora_down"] = lora[m]["down"].detach()
                self.trainable[f"{m}.lora_up"] = lora[m]["up"].detach()
        elif sketch_probe is not None:
            self.fixed = dict(params)
            self.fixed.update({f"{m}.lora_down": ab["down"] for m, ab in sketch_probe.items()})
            self.trainable = {f"{m}.lora_up": ab["up"] for m, ab in sketch_probe.items()}
        else:
            names = list(params_filter) if params_filter is not None else list(params)
            missing = [n for n in names if n not in params]
            if missing:
                raise ValueError(f"params_filter names unknown parameters {missing[:4]}")
            self.trainable = {n: params[n] for n in names}
            self.fixed = {n: p for n, p in params.items() if n not in self.trainable}
        self.names: List[str] = list(self.trainable)
        self.dim = sum(t.numel() for t in self.trainable.values())

        def scalar_out(trainable, x, t, noise, *context):
            args = (x[None], t[None]) + tuple(c[None] for c in context)
            eps = functional_call(model, {**self.fixed, **trainable}, args)
            return self.f(eps[0], noise)

        self.conditional = conditional
        in_dims = (None, 0, 0, 0) + ((0,) if conditional else ())
        self._grads = vmap(grad(scalar_out), in_dims=in_dims)

    def accumulate(self, acc: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
                   noise: torch.Tensor,
                   encoder_hidden_states: Optional[torch.Tensor] = None) -> None:
        """acc (B, dim) += per-sample gradients at model input x (B, C, H, W),
        timesteps t (B,) and the output function's noise, and for a
        conditional model each sample's context (B, M, D), in place, leaf by
        leaf."""
        b = x.shape[0]
        if self.conditional != (encoder_hidden_states is not None):
            raise ValueError("a conditional model takes encoder_hidden_states, and only it")
        context = () if encoder_hidden_states is None else (encoder_hidden_states,)
        grads = self._grads(self.trainable, x, t, noise, *context)
        offset = 0
        for name in self.names:
            g = grads.pop(name).reshape(b, -1)
            acc[:, offset:offset + g.shape[1]] += g
            offset += g.shape[1]


def _noises(noise, count, shape, generator, device):
    if noise is not None:
        if len(noise) != count:
            raise ValueError(f"noise: {len(noise)} tensors for {count} timesteps")
        return [n.to(device) for n in noise]
    if generator is None:
        raise ValueError("features need injected noise or a generator to draw it")
    return [torch.randn(shape, generator=generator, device=device) for _ in range(count)]


def make_grad_feature_fn(
    model: nn.Module,
    schedule: ScheduleState,
    spec: SchedulerSpec,
    output_fn: str = "loss",
    proj_dim: int = 4096,
    num_timesteps: int = 10,
    t_strategy: str = "uniform",
    proj_seed: int = 0,
    params_filter: Optional[Sequence[str]] = None,
    sketch_probe: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    lora: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    conditional: bool = False,
):
    """A (images, generator=None, noise=None, encoder_hidden_states=None) ->
    (B, proj_dim) extractor for images (B, C, H, W) in model space on the
    model's device; a `conditional` model takes each image's context
    (B, M, D) as `encoder_hidden_states`.

    Per timestep of the grid it q-samples x_t from the images and one noise
    draw, adds the per-sample gradients of f into the (B, D) buffer, then
    projects the timestep mean. `noise` is a list of one tensor per timestep.
    The returned function's `mean_gradients` (same arguments) gives the
    timestep mean before the projection, and `dim` its width.
    `params_filter`, `sketch_probe` and `lora` are as in
    `PerSampleGradients`."""
    grads = PerSampleGradients(model, output_fn, params_filter, sketch_probe, lora, conditional)
    ts = feature_timesteps(spec.num_train_timesteps, num_timesteps, t_strategy)

    def mean_gradients(images: torch.Tensor, generator: Optional[torch.Generator] = None,
                       noise: Optional[Sequence[torch.Tensor]] = None,
                       encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, device = images.shape[0], images.device
        acc = torch.zeros((b, grads.dim), dtype=torch.float32, device=device)
        for t, n in zip(ts, _noises(noise, len(ts), images.shape, generator, device)):
            t_b = torch.full((b,), int(t), dtype=torch.long, device=device)
            grads.accumulate(acc, add_noise(schedule, images, n, t_b), t_b, n,
                             encoder_hidden_states)
        return acc.div_(float(len(ts)))

    def features(images: torch.Tensor, generator: Optional[torch.Generator] = None,
                 noise: Optional[Sequence[torch.Tensor]] = None,
                 encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        return jl_project(mean_gradients(images, generator, noise, encoder_hidden_states),
                          proj_dim, seed=proj_seed)

    features.mean_gradients = mean_gradients
    features.dim = grads.dim
    return features


def make_journey_feature_fn(
    model: nn.Module,
    schedule: ScheduleState,
    spec: SchedulerSpec,
    output_fn: str = "loss",
    proj_dim: int = 4096,
    proj_seed: int = 0,
    params_filter: Optional[Sequence[str]] = None,
    sketch_probe: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    lora: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    conditional: bool = False,
):
    """Journey-TRAK features: gradients at the latents a sampling run visited
    (`diffusion.sampling.sample_with_trajectory`), not at fresh q-samples.
    A (trajectory (T, B, C, H, W), timesteps (T,), generator=None,
    noise=None, encoder_hidden_states=None) -> (B, proj_dim) extractor; the
    noise (one tensor per point) enters only the output function.
    `mean_gradients` and `dim` as in `make_grad_feature_fn`."""
    grads = PerSampleGradients(model, output_fn, params_filter, sketch_probe, lora, conditional)

    def mean_gradients(trajectory: torch.Tensor, timesteps: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[Sequence[torch.Tensor]] = None,
                       encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        steps, b = trajectory.shape[:2]
        device = trajectory.device
        acc = torch.zeros((b, grads.dim), dtype=torch.float32, device=device)
        draws = _noises(noise, steps, trajectory.shape[1:], generator, device)
        for latents, t, n in zip(trajectory, timesteps.tolist(), draws):
            t_b = torch.full((b,), int(t), dtype=torch.long, device=device)
            grads.accumulate(acc, latents, t_b, n, encoder_hidden_states)
        return acc.div_(float(steps))

    def features(trajectory: torch.Tensor, timesteps: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[Sequence[torch.Tensor]] = None,
                 encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        return jl_project(mean_gradients(trajectory, timesteps, generator, noise,
                                         encoder_hidden_states), proj_dim, seed=proj_seed)

    features.mean_gradients = mean_gradients
    features.dim = grads.dim
    return features


def compute_gradient_scores(
    train_features: np.ndarray,
    gen_features: np.ndarray,
    method: str = "trak",
    lambda_reg: float = 5e-1,
) -> np.ndarray:
    """(n_train, n_gen) attribution scores from projected gradient features.

    Methods (reference compute_gradient_score.py:114-126):
      trak            Phi_t (Phi_t^T Phi_t + lam I)^-1 Phi_g^T
      relative_if     trak rows / ||kernel-weighted train row||
      renormalized_if trak rows / ||train row||
      grad_sim        Phi_t Phi_g^T (cosine on request)
    """
    phi_t = np.asarray(train_features, np.float64)
    phi_g = np.asarray(gen_features, np.float64)
    if method == "grad_sim":
        return phi_t @ phi_g.T

    d = phi_t.shape[1]
    kernel = phi_t.T @ phi_t + lambda_reg * np.eye(d)
    kernel_inv = np.linalg.inv(kernel)
    scores = phi_t @ kernel_inv @ phi_g.T
    if method == "trak":
        return scores
    if method == "relative_if":
        norms = np.linalg.norm(phi_t @ kernel_inv, axis=1, keepdims=True)
        return scores / np.maximum(norms, 1e-12)
    if method == "renormalized_if":
        norms = np.linalg.norm(phi_t, axis=1, keepdims=True)
        return scores / np.maximum(norms, 1e-12)
    raise ValueError(f"unknown method {method!r}")


def aggregate_by_group(
    scores: np.ndarray, group_labels: Sequence[int], mode: str = "sum"
) -> np.ndarray:
    """Collapse per-example scores (n_train, n_gen) to per-group attributions
    (reference attribution_utils.aggregate_by_class :15-48; sum/mean/max)."""
    labels = np.asarray(group_labels)
    groups = np.unique(labels)
    per_gen = scores.mean(axis=1)
    out = np.zeros(len(groups))
    for i, g in enumerate(groups):
        vals = per_gen[labels == g]
        if mode == "sum":
            out[i] = vals.sum()
        elif mode == "mean":
            out[i] = vals.mean()
        elif mode == "max":
            out[i] = vals.max()
        else:
            raise ValueError(f"unknown mode {mode!r}")
    return out
