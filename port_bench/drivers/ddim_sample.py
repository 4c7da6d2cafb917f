"""DDIM sampling of one model: the program's `diffusion.sampling.make_sampler`
as the ensemble CLI builds it for a member's EMA weights (DDIM, eta 0).

Set-up makes the U-Net's weights from the seed and warms the one shape the
traffic uses with two forward calls at the batch. Each call of the window
denoises one batch of fresh initial noise, drawn from the seed and the call's
number, through every inference step; an image counts once all its steps
are done. The images are kept on the device, and the reference redraws the
noise of a sample of them, chosen from the seed, and denoises it again.
"""

from __future__ import annotations

import gc
import time
from importlib import import_module
from typing import Dict, List

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchlib import models, traffic
from benchlib.models import sync
from benchlib.weights import lecun_state_dict
from reference.jobs import ddim_images


class Driver:
    def __init__(self, ctx):
        self.ctx, self.cfg, self.tr = ctx, ctx.config, ctx.traffic
        u = self.cfg["unet"]
        self.shape = (self.tr["batch"], u["in_channels"], u["sample_size"], u["sample_size"])
        self.steps = self.tr["num_inference_steps"]
        self.spans: List[tuple] = []
        self.recording = False
        self.images: List[torch.Tensor] = []

    def _noise(self, call: int, *extra: int) -> torch.Tensor:
        return traffic.normal(self.shape, self.ctx.device, self.ctx.seed, traffic.NOISE, call,
                              *extra)

    def setup(self) -> None:
        port, cfg, dev = self.ctx.port, self.cfg, self.ctx.device
        sampling = import_module(f"{port.__name__}.diffusion.sampling")
        unet_mod = import_module(f"{port.__name__}.models.unet2d")
        model = unet_mod.empty_unet(models.unet_spec(port, cfg), device=dev)
        model.load_state_dict(lecun_state_dict(models.reference_unet(cfg, "meta"),
                                               self.ctx.seed, dev))
        self.model = model.eval()

        def timed(x, t):
            # The benchmark's span around each call into the model (no synchronise).
            s0 = time.perf_counter()
            with torch.profiler.record_function("bench::denoise"):
                out = self.model(x, t)
            if self.recording:
                self.spans.append((time.perf_counter() - s0, 1))
            return out

        self.sampler = sampling.make_sampler(
            timed, models.scheduler_spec(port, cfg), self.shape, device=dev,
            num_inference_steps=self.steps, eta=self.tr["eta"], kind="ddim")
        with torch.inference_mode():
            x = self._noise(0, 1)
            t = torch.full((self.shape[0],), 1, dtype=torch.long, device=dev)
            for _ in range(2):
                self.model(x, t)

    def window(self, seconds: float) -> Dict[str, object]:
        sync(self.ctx.device)
        self.recording = True
        t0 = time.perf_counter()
        while True:
            self.images.append(self.sampler(init_noise=self._noise(len(self.images))))
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.ctx.device)
        wall = time.perf_counter() - t0
        self.recording = False
        calls = len(self.images)
        images = calls * self.shape[0]
        failed = int(sum(int((~torch.isfinite(im.flatten(1))).any(1).sum()) for im in self.images))
        return {"units": calls * self.steps, "wall_s": wall, "spans": list(self.spans),
                "attempted": images, "failed": failed, "rates": {"images_per_s": images / wall}}

    def traced(self) -> int:
        self.sampler(init_noise=self._noise(0, 2))
        return self.steps

    def flops_per_unit(self) -> float:
        """Model FLOPs of one denoise step, counted on the plain reference at
        the cell's batch on the meta device: one forward."""
        model = models.reference_unet(self.cfg, "meta")
        x = torch.empty(self.shape, device="meta")
        t = torch.zeros(self.shape[0], dtype=torch.long, device="meta")
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            model(x, t)
        return float(counter.get_total_flops())

    def release(self) -> None:
        del self.model, self.sampler
        gc.collect()

    def checked_rows(self) -> List[tuple]:
        """(call, row) of the images the reference denoises again: a sample
        drawn from the seed over every image of the window."""
        n = len(self.images) * self.shape[0]
        pick = traffic.rng(self.ctx.seed, traffic.SAMPLE).choice(
            n, size=min(self.tr["checked_images"], n), replace=False)
        return sorted((int(i) // self.shape[0], int(i) % self.shape[0]) for i in pick)

    def program_images(self) -> torch.Tensor:
        return torch.stack([self.images[c][r] for c, r in self.checked_rows()])

    def reference(self, variant=None) -> torch.Tensor:
        cfg, dev = self.cfg, self.ctx.device
        model = models.reference_unet(cfg, "meta")
        model.load_state_dict(lecun_state_dict(model, self.ctx.seed, dev), assign=True)
        rows = self.checked_rows()
        noise = {c: self._noise(c) for c in {c for c, _ in rows}}
        start = torch.stack([noise[c][r] for c, r in rows])
        return ddim_images(model, cfg, start, self.steps, self.tr["reference_batch"], variant)

    def check(self) -> Dict[str, float]:
        diff = (self.program_images() - self.reference()).abs()
        return {"image_max_abs": float(diff.max())}
