"""Identification: local maxima, net gradient, threshold.

A pixel is a spot candidate when it is the first maximum, in row-major
order, of the box x box window around it, and lies at least box // 2
pixels inside the frame (box // 2 + 1 on the high side). Its net
gradient is the sum over that window of the central-difference gradient
(rows and columns wrapping around the frame's edges) dotted with the
unit vector from each pixel toward the centre. A candidate whose net
gradient exceeds the minimum is identified.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

#: bytes of the window tensor a block of frames may take
BLOCK_BYTES = 1e9


def unit_vectors(box: int, dtype, device):
    """(uy, ux): the unit vector from each window pixel toward its
    centre (0 at the centre)."""
    half = box // 2
    v = half - torch.arange(box, dtype=torch.float64)
    uy, ux = torch.meshgrid(v, v, indexing="ij")
    norm = torch.sqrt(uy * uy + ux * ux)
    norm[half, half] = 1.0
    return (uy / norm).to(device, dtype), (ux / norm).to(device, dtype)


def upload(frames: np.ndarray, device) -> torch.Tensor:
    """A numpy block of frames on ``device`` as int32 (u16 through an
    int16 view, widened there)."""
    if frames.dtype == np.uint16:
        t = torch.from_numpy(np.ascontiguousarray(frames).view(np.int16))
        return t.to(device).to(torch.int32) & 0xFFFF
    return torch.from_numpy(np.ascontiguousarray(frames)).to(device)


def identify(frames, box: int, min_net_gradient: float,
             dtype=torch.float64, device=None):
    """Identifications of a (B, Y, X) stack (numpy or tensor), worked in
    ``dtype`` on ``device`` a block of frames at a time: (frame, y, x, net_gradient) tensors, ordered
    by frame, then row, then column."""
    if device is None:
        device = frames.device if isinstance(frames, torch.Tensor) else "cpu"
    B, Y, X = frames.shape
    h = box // 2
    centre = (box * box) // 2
    uy, ux = unit_vectors(box, dtype, device)
    # the maxima compare counts, exact in f32 below 2^24; a lower dtype
    # (the control's) compares in its own
    cmp = torch.float32 if dtype == torch.float64 else dtype
    elt = torch.empty((), dtype=cmp).element_size()
    step = max(1, int(BLOCK_BYTES // (box * box * Y * X * elt)))
    off = torch.arange(box, device=device) - h
    out = [[], [], [], []]
    for lo in range(0, B, step):
        f = frames[lo:lo + step]
        if isinstance(f, np.ndarray):
            f = upload(f, device)
        f = f.to(device).to(dtype)
        nb = len(f)
        win = F.unfold(f[:, None].to(cmp), box)  # (nb, box^2, L)
        first_max = win.argmax(dim=1) == centre
        first_max = first_max.view(nb, Y - box + 1, X - box + 1)
        # centre rows h .. Y - h - 1; the last one is not eligible
        first_max[:, -1, :] = False
        first_max[:, :, -1] = False
        b, cy, cx = torch.nonzero(first_max, as_tuple=True)
        y, x = cy + h, cx + h
        gy = torch.roll(f, -1, 1) - torch.roll(f, 1, 1)
        gx = torch.roll(f, -1, 2) - torch.roll(f, 1, 2)
        rows = y[:, None, None] + off[None, :, None]
        cols = x[:, None, None] + off[None, None, :]
        ng = (gy[b[:, None, None], rows, cols] * uy).sum((1, 2)) \
            + (gx[b[:, None, None], rows, cols] * ux).sum((1, 2))
        keep = ng > min_net_gradient
        for acc, v in zip(out, (b[keep] + lo, y[keep], x[keep], ng[keep])):
            acc.append(v)
    return tuple(torch.cat(a) for a in out)
