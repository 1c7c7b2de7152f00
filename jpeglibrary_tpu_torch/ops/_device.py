"""Where an entry point runs when its caller names no device.

The port's entry points run on the card unless the caller asks for the
CPU. :func:`default_device` is the one place that decides it: the CUDA
device, or a ``RuntimeError`` that tells the caller to pass
``device="cpu"``. There is no quiet fallback to the CPU. The encoders
also read the JAX package's ``xp`` (:func:`encode_target`): numpy is the
host encoder, ``torch`` the card and a ``torch.device`` that device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def default_device() -> torch.device:
    """``torch.device("cuda")``; raises ``RuntimeError`` without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card unless asked "
            'otherwise; pass device="cpu" (or xp=torch.device("cpu")) to run on the CPU')
    return torch.device("cuda")


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``, or :func:`default_device` for None."""
    return default_device() if device is None else torch.device(device)


def _same(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


def encode_target(xp=None, device=None) -> Optional[torch.device]:
    """The device an encode runs its transform on, None for the host
    encoder. ``xp`` is numpy (the host), ``torch`` (the card) or a
    ``torch.device``; anything else raises ``TypeError``. ``device`` names
    the device as before; given both, they must agree (``ValueError``).
    With neither, the card (:func:`default_device`)."""
    if xp is None:
        return resolve(device)
    if xp is np:
        target = None
    elif xp is torch:
        target = default_device()
    elif isinstance(xp, torch.device):
        target = xp
    else:
        raise TypeError(
            f"xp must be numpy (the host), torch (the card) or a torch.device, got {xp!r}")
    if device is not None and (target is None or not _same(target, torch.device(device))):
        raise ValueError(f"xp={xp!r} and device={device!r} name different places to encode")
    return target
