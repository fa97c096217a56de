"""The card a run uses: a run without the cards its cell asks for fails,
and never falls back to the CPU."""

from __future__ import annotations

import shutil
import subprocess

FORBIDDEN = ("jax", "jaxlib", "flax", "picasso_tpu")


class NoDevice(RuntimeError):
    pass


def require_cuda(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False: this benchmark "
                       "measures the CUDA port and does not run on the CPU")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, "
                       f"torch.cuda.device_count() is "
                       f"{torch.cuda.device_count()}")


def power_limit_w() -> float | None:
    """The card's power limit in W from nvidia-smi, or None."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", "0"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def describe(device, chips: int) -> dict:
    """The result line's ``device``: platform, kind, count and the peak
    of the card's allocator (a CPU device, in the tests, reads 0)."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit_w": power_limit_w()}


def forbidden_modules(modules) -> list[str]:
    """The loaded modules whose top-level name (before the first dot,
    compared whole) is one of :data:`FORBIDDEN`: ``picasso_torch`` begins
    with the letters of ``picasso_tpu`` and is not one of them."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)
