"""The configuration file's sizes as the program's specs, and the plain
reference's model, on any device, for a configuration."""

from __future__ import annotations

import dataclasses

import torch

# Keys of a configuration's ``unet`` group that only the reference reads:
# the program fixes them in code, and the file states the values it uses.
REFERENCE_ONLY = ("gelu", "transformer_layer_norm_eps")


def unet_spec(port, config: dict):
    from importlib import import_module

    UNetSpec = import_module(f"{port.__name__}.config.registry").UNetSpec
    u = {k: tuple(v) if isinstance(v, list) else v for k, v in config["unet"].items()
         if k not in REFERENCE_ONLY}
    return UNetSpec(**u)


def scheduler_spec(port, config: dict):
    from importlib import import_module

    SchedulerSpec = import_module(f"{port.__name__}.config.registry").SchedulerSpec
    fields = {f.name for f in dataclasses.fields(SchedulerSpec)}
    return SchedulerSpec(**{k: v for k, v in config["scheduler"].items() if k in fields})


def reference_unet(config: dict, device) -> torch.nn.Module:
    """The plain reference U-Net of `config`, its parameters on `device`
    uninitialised (the meta device holds shapes only)."""
    import reference.unet as ref

    with torch.device(device):
        return ref.UNet(config["unet"])


def sync(device) -> None:
    """Wait for the device (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
