"""Whole runs of the tiny cells on the CPU, past the harness's look for a
card: a sound program comes out correct, and each fault a cell can have,
planted in the program underneath the timed path, comes out not correct.
And the command itself refuses to run without a card."""

import copy
import os
import subprocess
import sys

import pytest
import torch

import tiny
from benchlib import runner

PORT = runner.PORT


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make_bench(str(tmp_path_factory.mktemp("bench")))


def run(bench, cell, trace=False):
    return runner.run(tiny.ROOT, cell, 2**31 + 77, 0.2, trace, require_chip=False,
                      device="cpu", manifest=bench)


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_a_sound_run_is_correct(bench, cell):
    result = run(bench, cell, trace=True)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {"mfu", "host_ms_per_step"} <= {k.split(".")[0] for k in result["metrics"]}


def _module(name):
    runner.import_port(tiny.ROOT)
    import importlib

    return importlib.import_module(f"{PORT}.{name}")


def _ensemble_unchanged(monkeypatch):
    ens = _module("parallel.ensemble")

    def step(self, state, step_seed):  # the losses, and the state left as it was
        raw, t, noise = self.draws(step_seed)
        saved = copy.deepcopy((state.params, state.ema, state.opt_state, state.step))
        metrics = self._members_step(state, self.batch(raw), t, noise)
        state.params, state.ema, state.opt_state, state.step = saved
        return metrics

    monkeypatch.setattr(ens.EnsembleTrainer, "step", step)


def _ensemble_half(monkeypatch):
    ens = _module("parallel.ensemble")

    def step(self, state, step_seed):
        raw, t, noise = self.draws(step_seed)
        h = self.batch_size // 2
        return self._members_step(state, self.batch(raw)[:, :h], t[:, :h], noise[:, :h])

    monkeypatch.setattr(ens.EnsembleTrainer, "step", step)


def _lora_unchanged(monkeypatch):
    cli = _module("cli.train_text_to_image_lora")
    real = cli.members_step

    def members_step(model, lora, tx, opt_state, *args, **kw):
        lora = {n: {k: v.detach().clone().requires_grad_(True) for k, v in ab.items()}
                for n, ab in lora.items()}
        return real(model, lora, tx, copy.deepcopy(opt_state), *args, **kw)

    monkeypatch.setattr(cli, "members_step", members_step)


def _lora_half(monkeypatch):
    cli = _module("cli.train_text_to_image_lora")
    real = cli.members_step

    def members_step(model, lora, tx, opt_state, latents, captions, group_of, idx, t, noise,
                     *args, **kw):
        h = idx.shape[1] // 2
        return real(model, lora, tx, opt_state, latents, captions, group_of, idx[:, :h],
                    t[:, :h], noise[:, :h], *args, **kw)

    monkeypatch.setattr(cli, "members_step", members_step)


def _ddim_unchanged(monkeypatch):
    sampling = _module("diffusion.sampling")
    monkeypatch.setattr(sampling, "ddim_step", lambda state, spec, eps, t, t_prev, x, **kw: x)


def _ddim_half(monkeypatch):
    sampling = _module("diffusion.sampling")
    real = sampling.sample_loop

    def sample_loop(model, schedule, spec, shape, *, init_noise, **kw):
        h = shape[0] // 2
        first = real(model, schedule, spec, (h,) + tuple(shape[1:]), init_noise=init_noise[:h],
                     **kw)
        return torch.cat([first, torch.zeros_like(init_noise[h:])])

    monkeypatch.setattr(sampling, "sample_loop", sample_loop)


def _ddim_altered(monkeypatch):
    sampling = _module("diffusion.sampling")
    real = sampling.sample_loop

    def sample_loop(*args, **kw):
        images = real(*args, **kw).clone()
        images[:, 0, 0, 0] += 0.01  # one pixel of every answer
        return images

    monkeypatch.setattr(sampling, "sample_loop", sample_loop)


FAULTS = {
    ("tiny_ensemble_train", "state unchanged"): _ensemble_unchanged,
    ("tiny_ensemble_train", "half batch"): _ensemble_half,
    ("tiny_lora_train", "state unchanged"): _lora_unchanged,
    ("tiny_lora_train", "half batch"): _lora_half,
    ("tiny_ddim_sample", "state unchanged"): _ddim_unchanged,
    ("tiny_ddim_sample", "half batch"): _ddim_half,
    ("tiny_ddim_sample", "answer altered"): _ddim_altered,
}


@pytest.mark.parametrize("cell,fault", list(FAULTS))
def test_a_fault_is_not_correct(bench, monkeypatch, cell, fault):
    FAULTS[(cell, fault)](monkeypatch)
    result = run(bench, cell)
    assert not result["correct"], result["checks"]


def test_the_command_needs_a_card():
    """Without CUDA the command prints no result and exits with 2."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(tiny.BENCH_DIR, "run.py"),
                           "--workload", "cifar_ensemble_train", "--seed", "1",
                           "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=tiny.ROOT, env=env, timeout=300)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr
