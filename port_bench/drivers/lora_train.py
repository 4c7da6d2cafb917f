"""Stacked LoRA fine-tuning of subset models over one frozen base: the
program's `cli.train_text_to_image_lora.members_step`, driven by a copy of
that CLI's training loop.

Set-up makes the frozen base's weights, the stand-ins of the frozen towers'
outputs (caption embeddings, one per group, and the images' latents), the
heavy-tailed group sizes, each member's Shapley-kernel coalition of groups
and the members' LoRA factors (down N(0, 1) / r, up 0) from the seed, and
the optimizer as the CLI builds it (AdamW, weight decay, cosine schedule, a
clip per member). Each step draws every member's slots, timesteps and noise
on the device from a generator of its own, as the CLI does, calls
`members_step` and waits for the device, as the CLI's loop does. The first
`checked_steps` steps are kept for the reference (losses, the first gradient
as AdamW holds it, the factors' change) and warm every shape.
"""

from __future__ import annotations

import gc
import time
from importlib import import_module
from typing import Dict, List

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchlib import compare, models, traffic
from benchlib.models import sync
from benchlib.weights import lecun_state_dict
from reference.diffusion import ADAM_B1, leaf_norms
from reference.jobs import lora_layout, lora_record
from reference.unet import lora_targets


class Driver:
    def __init__(self, ctx):
        self.ctx, self.cfg, self.tr = ctx, ctx.config, ctx.traffic
        self.members, self.batch = self.tr["members"], self.tr["batch"]
        self.checked = self.tr["checked_steps"]
        d = self.cfg["data"]
        self.latent_shape = tuple(d["latent_chw"])
        self.timesteps = self.cfg["scheduler"]["num_train_timesteps"]

    # --- inputs, made by the benchmark and handed to both sides -------------------

    def _data(self):
        seed, dev, d = self.ctx.seed, self.ctx.device, self.cfg["data"]
        latents = traffic.normal((d["images"], *self.latent_shape), dev, seed, traffic.DATA)
        captions = traffic.normal((d["groups"], *d["caption_shape"]), dev, seed,
                                  traffic.CAPTIONS)
        sizes = traffic.heavy_tailed_sizes(d["images"], d["groups"], d["group_size_sigma"], seed)
        group_of = traffic.group_of_rows(sizes, seed)
        subsets = traffic.shapley_group_subsets(group_of, d["groups"], self.members,
                                                self.batch, seed)
        return (latents, captions, torch.as_tensor(group_of, device=dev),
                [torch.as_tensor(s, device=dev) for s in subsets])

    def _lora(self, layout) -> Dict[str, Dict[str, torch.Tensor]]:
        """The members' starting factors, stacked: {projection: {"down": (M,
        in, r), "up": (M, r, out)}}, all downs from one draw."""
        dev, m = self.ctx.device, self.members
        total = sum(i * r for _, i, r, _ in layout)
        flat = traffic.normal((m, total), dev, self.ctx.seed, traffic.LORA)
        tree, off = {}, 0
        for name, i, r, o in layout:
            tree[name] = {"down": (flat[:, off:off + i * r].reshape(m, i, r) / r).contiguous(),
                          "up": torch.zeros((m, r, o), device=dev)}
            off += i * r
        return tree

    def _draws(self, step: int, member: int, rows: int) -> Dict[str, torch.Tensor]:
        return traffic.lora_step_draws(self.ctx.seed, step, member, rows, self.batch,
                                       self.timesteps, self.latent_shape, self.ctx.device)

    # --- the program -----------------------------------------------------------

    def setup(self) -> None:
        port, cfg, dev = self.ctx.port, self.cfg, self.ctx.device
        cli = import_module(f"{port.__name__}.cli.train_text_to_image_lora")
        state_mod = import_module(f"{port.__name__}.training.state")
        sched_mod = import_module(f"{port.__name__}.diffusion.schedulers")
        unet_mod = import_module(f"{port.__name__}.models.unet2d")
        meta = models.reference_unet(cfg, "meta")
        model = unet_mod.empty_unet(models.unet_spec(port, cfg), device=dev)
        model.load_state_dict(lecun_state_dict(meta, self.ctx.seed, dev))
        self.model = model.eval().requires_grad_(False)
        self.latents, self.captions, self.group_of, self.subsets = self._data()
        self.tree = self._lora(lora_layout(meta, cfg["lora"]["rank"]))
        start = {f"{n}.{k}": ab[k].clone() for n, ab in self.tree.items() for k in ("down", "up")}
        self.leaves = cli.lora_leaves(self.tree)
        for leaf in self.leaves:
            leaf.requires_grad_(True)
        opt = cfg["train"]["optimizer"]
        self.tx = state_mod.make_optimizer(
            opt["name"], lr=opt["lr"], weight_decay=opt["weight_decay"],
            lr_schedule=opt["lr_schedule"], total_steps=opt["total_steps"],
            grad_clip_norm=opt["grad_clip_norm"])
        self.opt_state = self.tx.init(self.leaves)
        self.schedule = sched_mod.make_schedule(models.scheduler_spec(port, cfg), dev)
        self.members_step = cli.members_step
        names = list(start)
        losses = []
        for k in range(self.checked):
            losses.append(self._step(k).cpu())
            if k == 0:
                first = {n: mu.clone() for n, mu in zip(names, self.opt_state.mu)}
        losses = torch.stack(losses)
        self.program = [{
            "losses": losses[:, m].tolist(),
            "grad1": leaf_norms({n: first[n][m] / (1.0 - ADAM_B1) for n in names}),
            "change": leaf_norms({n: leaf[m].detach() - start[n][m]
                                  for n, leaf in zip(names, self.leaves)}),
        } for m in range(self.members)]
        self.next_step = self.checked

    def _step(self, k: int) -> torch.Tensor:
        """Step k of the CLI's loop: each member's draws, then one call of
        `members_step` for all of them; the caller waits for the device, as
        the CLI's loop does after every step."""
        draws = []
        for m, rows in enumerate(self.subsets):
            d = self._draws(k, m, len(rows))
            draws.append((rows[d["slot"]], d["t"], d["noise"]))
        idx, t, noise = (torch.stack(x) for x in zip(*draws))
        return self.members_step(self.model, self.tree, self.tx, self.opt_state, self.latents,
                                 self.captions, self.group_of, idx, t, noise, self.schedule)

    def window(self, seconds: float) -> Dict[str, object]:
        spans, failed, steps = [], 0, 0
        sync(self.ctx.device)
        t0 = time.perf_counter()
        while True:
            s0 = time.perf_counter()
            losses = self._step(self.next_step)
            spans.append((time.perf_counter() - s0, 1))
            sync(self.ctx.device)
            failed += int((~torch.isfinite(losses)).sum())
            self.next_step += 1
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        return {"units": steps, "wall_s": wall, "spans": spans,
                "attempted": steps * self.members, "failed": failed,
                "rates": {"member_steps_per_s": steps * self.members / wall}}

    def traced(self) -> int:
        steps = self.tr["traced_steps"]
        for _ in range(steps):
            with torch.profiler.record_function("bench::lora_step"):
                self._step(self.next_step)
            sync(self.ctx.device)
            self.next_step += 1
        return steps

    def flops_per_unit(self) -> float:
        """Model FLOPs of one ensemble step, counted on the plain reference at
        the cell's shapes on the meta device: each member's forward through
        the frozen base with its LoRA branches, and the backward to the LoRA
        factors (no weight gradient of the base)."""
        cfg = self.cfg
        model = models.reference_unet(cfg, "meta").requires_grad_(False)
        leaves = []
        for name, module in lora_targets(model):
            r = min(cfg["lora"]["rank"], module.in_features, module.out_features)
            down = torch.empty((module.in_features, r), device="meta", requires_grad=True)
            up = torch.empty((r, module.out_features), device="meta", requires_grad=True)
            module.lora = (down, up)
            leaves += [down, up]
        d = cfg["data"]
        x = torch.empty((self.batch, *self.latent_shape), device="meta")
        t = torch.zeros(self.batch, dtype=torch.long, device="meta")
        ctx = torch.empty((self.batch, *d["caption_shape"]), device="meta")
        with FlopCounterMode(display=False) as counter:
            loss = ((model(x, t, ctx) - x) ** 2).mean()
            torch.autograd.grad(loss, leaves)
        return float(counter.get_total_flops()) * self.members

    def release(self) -> None:
        del self.model, self.tree, self.leaves, self.opt_state, self.latents, self.captions
        gc.collect()

    # --- the reference ----------------------------------------------------------

    def reference(self, variant=None) -> List[Dict[str, object]]:
        cfg, dev = self.cfg, self.ctx.device
        model = models.reference_unet(cfg, "meta")
        model.load_state_dict(lecun_state_dict(model, self.ctx.seed, dev), assign=True)
        model.requires_grad_(False)
        layout = lora_layout(model, cfg["lora"]["rank"])
        latents, captions, group_of, subsets = self._data()
        tree = self._lora(layout)
        out = []
        for m, rows in enumerate(subsets):
            lora = {n: {k: v[m] for k, v in ab.items()} for n, ab in tree.items()}
            out.append(lora_record(
                model, cfg, lora, latents, captions, group_of, rows,
                lambda k, m=m, n=len(rows): self._draws(k, m, n), self.checked, self.batch,
                self.tr["reference_microbatch"], variant))
            gc.collect()
        return out

    def check(self) -> Dict[str, float]:
        return compare.training_numbers(self.program, self.reference())
