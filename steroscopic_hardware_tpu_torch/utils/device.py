"""The port's explicit device rule, shared by the ops and the engines."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device) -> torch.device:
    """The explicit device rule: "cuda" needs a usable GPU and raises
    without one (no silent CPU fallback); "cpu" runs the plain versions."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device 'cpu' to run the plain torch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def card_name(device) -> str:
    """``name, power.limit`` of the card as ``nvidia-smi`` gives them (the
    first card), or "cpu" for a CPU device."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()
