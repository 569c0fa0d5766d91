"""Device resolution: the port runs on the card unless the caller asks for
the CPU, and never falls back to the CPU on its own."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """`device` as a torch.device; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (or --device cpu) to run the "
            "plain PyTorch versions on the CPU")
    return dev


def device_list(devices=None, device="cuda") -> list[torch.device]:
    """The devices of a sharded call: `devices` resolved (a list may name
    one device more than once), or by default every visible card when
    `device` is a card and `[device]` when it is the CPU.  Raises when a
    card is asked for and there is none."""
    dev = resolve_device(device)
    if devices is None:
        devices = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("a sharded call needs at least one device")
    return out


def on_device(device: torch.device):
    """A context that makes `device` the current card (nothing for the
    CPU), so that a kernel launched inside runs on that card's current
    stream."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
