"""Stacked retraining of subset models: the estimation loop's call of the
program's `parallel.ensemble.EnsembleTrainer`.

Set-up makes the stand-in dataset (uint8 images of balanced classes), each
member's Shapley-kernel class subset and the one U-Net's weights from the
seed, builds the trainer as the ensemble CLI does (common random numbers,
every member from the same weights, Adam with the configuration's clip) and
drives its first `checked_steps` steps through `run_scanned`, the call the
window drives, keeping what the reference is compared on: each step's
losses, the first gradient as Adam holds it (its first moment after one
step is 1 - b1 times it), and the change of the parameters and the EMA.
Those steps also warm every shape. The window then runs `run_scanned` in
chunks of `chunk` steps, the host reading the losses once a chunk, as the
CLI does; one member-step is one member's optimizer step at its full batch.
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
from reference.jobs import ensemble_record


class Driver:
    def __init__(self, ctx):
        self.ctx, self.cfg, self.tr = ctx, ctx.config, ctx.traffic
        self.members, self.batch, self.chunk = (self.tr["members"], self.tr["batch"],
                                                self.tr["chunk"])
        self.checked = self.tr["checked_steps"]
        self.first_seed = traffic.derive(ctx.seed, traffic.STEPS)

    def _inputs(self):
        cfg, seed, dev = self.cfg, self.ctx.seed, self.ctx.device
        data = cfg["data"]
        images = traffic.uint8_images(data["images"], data["hwc"], seed, dev)
        labels = traffic.balanced_labels(data["images"], data["classes"], seed)
        subsets = traffic.shapley_group_subsets(labels, data["classes"], self.members,
                                                self.batch, seed)
        weights = lecun_state_dict(models.reference_unet(cfg, "meta"), seed, dev)
        return images, subsets, weights

    def setup(self) -> None:
        port, cfg, dev = self.ctx.port, self.cfg, self.ctx.device
        ens = import_module(f"{port.__name__}.parallel.ensemble")
        state_mod = import_module(f"{port.__name__}.training.state")
        sched_mod = import_module(f"{port.__name__}.diffusion.schedulers")
        unet_mod = import_module(f"{port.__name__}.models.unet2d")
        images, subsets, weights = self._inputs()
        spec, sched = models.unet_spec(port, cfg), models.scheduler_spec(port, cfg)
        opt = cfg["train"]["optimizer"]
        tx = state_mod.make_optimizer(opt["name"], lr=opt["lr"],
                                      weight_decay=opt.get("weight_decay", 0.0),
                                      grad_clip_norm=opt.get("grad_clip_norm"))
        self.trainer = ens.EnsembleTrainer(
            tx=tx, schedule=sched_mod.make_schedule(sched, dev), spec=sched,
            images_u8=images.cpu().numpy(), member_indices=subsets, batch_size=self.batch,
            device=dev, common_noise=True)
        del images
        self.state = self.trainer.init_state(lambda s: unet_mod.empty_unet(spec, device=dev),
                                             params=weights)
        names = list(self.state.params)
        first: Dict[str, torch.Tensor] = {}

        def keep_first_moment(metrics, end):
            if end == 1:
                first.update({n: m.clone() for n, m in zip(names, self.state.opt_state.mu)})

        self.state, metrics = self.trainer.run_scanned(
            self.state, self.checked, seed=self.first_seed, chunk=1, chunk_fn=keep_first_moment)
        losses = metrics["loss"].cpu()
        ema = dict(zip(names, self.state.ema))
        self.program = [{
            "losses": losses[:, m].tolist(),
            "grad1": leaf_norms({n: first[n][m] / (1.0 - ADAM_B1) for n in names}),
            "change": leaf_norms({n: self.state.params[n][m].detach() - weights[n]
                                  for n in names}),
            "ema_change": leaf_norms({n: ema[n][m] - weights[n] for n in names}),
        } for m in range(self.members)]
        del first, weights

    def window(self, seconds: float) -> Dict[str, object]:
        spans, failed, c = [], 0, 0
        sync(self.ctx.device)
        t0 = time.perf_counter()
        while True:
            s0 = time.perf_counter()
            self.state, metrics = self.trainer.run_scanned(
                self.state, self.chunk,
                seed=traffic.derive(self.ctx.seed, traffic.STEPS, 1 + c), chunk=self.chunk)
            spans.append((time.perf_counter() - s0, self.chunk))
            losses = metrics["loss"].cpu()  # the host reads the losses once a chunk
            failed += int((~torch.isfinite(losses)).sum())
            c += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.ctx.device)
        wall = time.perf_counter() - t0
        steps = c * self.chunk
        return {"units": steps, "wall_s": wall, "spans": spans,
                "attempted": steps * self.members, "failed": failed,
                "rates": {"member_steps_per_s": steps * self.members / wall}}

    def traced(self) -> int:
        steps = self.tr["traced_steps"]
        with torch.profiler.record_function("bench::run_scanned"):
            self.state, metrics = self.trainer.run_scanned(
                self.state, steps, seed=traffic.derive(self.ctx.seed, traffic.STEPS, 0),
                chunk=steps)
        metrics["loss"].cpu()
        return steps

    def flops_per_unit(self) -> float:
        """Model FLOPs of one ensemble step, counted on the plain reference at
        the cell's shapes on the meta device: forward and backward of each
        member at its batch."""
        cfg = self.cfg
        model = models.reference_unet(cfg, "meta")
        u = cfg["unet"]
        x = torch.empty((self.batch, u["in_channels"], u["sample_size"], u["sample_size"]),
                        device="meta")
        t = torch.zeros(self.batch, dtype=torch.long, device="meta")
        with FlopCounterMode(display=False) as counter:
            ((model(x, t) - x) ** 2).mean().backward()
        return float(counter.get_total_flops()) * self.members

    def release(self) -> None:
        del self.trainer, self.state
        gc.collect()

    def reference(self, variant=None) -> List[Dict[str, object]]:
        images, subsets, weights = self._inputs()
        out = []
        for rows in subsets:
            out.append(ensemble_record(self.cfg, weights, images,
                                       torch.as_tensor(rows, device=self.ctx.device),
                                       self.first_seed, self.checked, self.batch, variant))
            gc.collect()
        return out

    def check(self) -> Dict[str, float]:
        return compare.training_numbers(self.program, self.reference())
