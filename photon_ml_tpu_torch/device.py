"""Device selection and the card's identity.

The port's entry points run on the CUDA card by default. With no CUDA device
they raise unless the caller asks for the CPU explicitly (``device="cpu"``):
nothing quietly drops to the CPU, because a number measured there is not the
card's.
"""

from __future__ import annotations

import subprocess
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card. A CUDA device with no card present raises."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def pin_device(device: DeviceLike = None) -> torch.device:
    """``resolve_device`` with a CUDA device's index filled in from the
    calling thread's current card, so that work begun later on another
    thread (a batcher's worker, a refresh watcher) lands on the same card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def fetch(site: str, tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """``tensors`` on the host in their own dtypes and shapes, bit for bit,
    moved in one device-to-host copy (their bytes concatenated where they
    lie) and counted as one fetch at ``site``
    (``photon_device_fetch_bytes_total{site=}``)."""
    from . import obs

    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    host = (torch.cat(flat) if len(flat) > 1 else flat[0]).cpu().numpy()
    obs.add_device_fetch_bytes(site, int(host.nbytes))
    out, start = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel()
        dt = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(host[start : start + n].view(dt).reshape(tuple(t.shape)))
        start += n
    return out


def nvidia_smi_identity() -> Optional[str]:
    """``name, power.limit`` as nvidia-smi prints it (one line per card), or
    None where nvidia-smi is absent. Every number the port prints is written
    beside this line: a card set below its maximum power runs slower."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()
