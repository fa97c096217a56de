"""Canonical DNA sequences for rectangular Rothemund origami (RRO)
designs: the standard RRO staple set and the DNA-PAINT docking handles.

Counterpart of picasso_tpu/design_sequences.py. The port reads its own
copies of the two tables from ``picasso_torch/data/``.
"""

from __future__ import annotations

import csv
import os

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


def _load_table(name: str) -> list[list[str]]:
    with open(os.path.join(_DATA_DIR, name), newline="") as f:
        return [row for row in csv.reader(f)]


# [Position, Name, Sequence] rows with a header row
base_sequences = _load_table("base_sequences.csv")

# [Shortname, Handlesequence] rows with a header row
paint_sequences = _load_table("paint_sequences.csv")


def get_paint_sequence(shortname: str) -> str:
    """The DNA-PAINT handle sequence of a short name (e.g. 'P1')."""
    for row in paint_sequences[1:]:
        if row[0] == shortname:
            return row[1]
    raise KeyError(f"Unknown PAINT sequence name: {shortname}")
