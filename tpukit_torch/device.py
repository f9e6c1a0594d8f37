# -*- coding: utf-8 -*-
"""The port's device: named by the caller, never guessed.

Replaces tpukit/hostinfo.py, which kept JAX's CPU platform reachable beside
an accelerator and fingerprinted the XLA:CPU compile cache. PyTorch runs
eagerly and has no compile cache to key, so neither is ported. What is left
is one rule: the caller names the device, and a CUDA device that is absent
is an error. The port never drops to the CPU on its own; tests ask for the
CPU explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``name`` ("cuda", "cuda:N" or "cpu"). Raises
    when CUDA is asked for and none is available."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but CUDA is not available; "
                f"pass --device cpu to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev
