"""The benchmark's own tests: on the CPU at small sizes, and marked
``cuda`` where they need the card (they skip without one).

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: a localize cell at a size a test run holds on the CPU
SMALL = {"frames": 48, "height": 64, "width": 64, "n_sites": 12,
         "warm_frames": 16, "check_frames": 48}
#: a wide PSF at box 17 (test data for the reference at a large box):
#: the fit and spot that replace the b7 configuration's, and sub-pixel
#: sites at least 17 px apart, four to a 64 x 64 field
WIDE_FIT = {"box": 17}
WIDE_SPOT = {"sigma": 2.5, "peak": 300, "footprint": 17, "background": 30}
WIDE_PARAMS = {"layout_seed": 1000, "n_sites": 4, "p_on": 0.5, "margin": 10,
               "margin_high": 11, "subpixel": True, "min_distance": 17,
               "movies": 1}


def wide_config(config: dict) -> dict:
    """The configuration ``config`` at box 17 with the wide spot."""
    return dict(config, fit=dict(config["fit"], **WIDE_FIT), spot=WIDE_SPOT)
#: three RCC segments of 1000 frames
SMALL_DRIFT = {"frames": 3000, "height": 64, "width": 64, "n_sites": 24}


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")
