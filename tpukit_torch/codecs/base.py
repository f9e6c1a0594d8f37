# -*- coding: utf-8 -*-
"""Work-cube adoption for the device codecs: port of
tpukit/codecs/base.py::device_work (:162-203).

The sweep runner uploads each tile once (``opts["device_cube"]``); a codec
takes its device work from that upload when the shape fits, converting on
the device, and otherwise converts on the host and uploads once, to the
same device. Without an upload the work stays on the CPU: the device is
always the caller's, never a default.
"""

from __future__ import annotations

import numpy as np
import torch

from tpukit_torch.codecs.wavelet_common import pad_to_multiple


_NUMPY = {torch.int32: np.int32, torch.float32: np.float32}


def work_device(opts: dict) -> torch.device:
    """The device of the runner's upload, the CPU without one."""
    dev = opts.get("device_cube")
    return dev.device if dev is not None else torch.device("cpu")


def edge_pad(x: torch.Tensor, Hp: int, Wp: int) -> torch.Tensor:
    """Pad the last two axes of (..., H, W) to (Hp, Wp) by repeating the
    last row and column, as ``np.pad(mode="edge")`` does, for any dtype."""
    H, W = x.shape[-2:]
    if Hp > H:
        x = torch.cat([x, x[..., -1:, :].expand(*x.shape[:-2], Hp - H, W)],
                      -2)
    if Wp > W:
        x = torch.cat([x, x[..., -1:].expand(*x.shape[:-1], Wp - W)], -1)
    return x.contiguous()


def device_work(cube: np.ndarray, opts: dict, multiple: int = 1,
                target: torch.dtype = torch.int32) -> torch.Tensor:
    """(B, Hp, Wp) tensor of ``cube`` in ``target`` dtype, edge-padded so
    that Hp and Wp are multiples of ``multiple``, on :func:`work_device`.
    The runner's upload is converted on the device when its shape is the
    cube's; otherwise the cube is converted on the host and uploaded once.
    (tpukit's uint16 bit view of int16 sources has no caller in the port
    yet.)"""
    B, H, W = cube.shape
    Hp, Wp = H + (-H) % multiple, W + (-W) % multiple
    dev = opts.get("device_cube")
    if dev is not None and tuple(dev.shape) == (B, H, W):
        return edge_pad(dev.to(target), Hp, Wp)
    host, _, _ = pad_to_multiple(cube.astype(_NUMPY[target]), multiple)
    return torch.from_numpy(np.ascontiguousarray(host)).to(work_device(opts))
