"""Rectangular Rothemund origami (RRO) plate design: canvas layouts to
pipetting plate lists (picasso_tpu/design.py:19-77; picasso/design.py
convertPlateIndex :21, readPlate :196, savePlate :215). Host code."""

from __future__ import annotations

import csv

from picasso_torch import io

# 96-well plate coordinates; a 16-row canvas spans two plates
_PLATE_ROWS = list("ABCDEFGH") * 2
_PLATE_COLS = list(range(1, 13))
_STRUCTURE_ROWS = list("ABCDEFGHIJKLMNOP")


def saveInfo(filename: str, info: dict) -> None:
    io.save_info(filename, [info], default_flow_style=True)


def _convert(plate: list, platename: str, with_color: bool) -> list:
    """Canvas rows [CANVAS_INDEX, OLIGONAME, SEQUENCE(, COLOR)] -> plate
    rows [PLATE NAME, PLATE POSITION, OLIGO NAME, SEQUENCE(, COLOR)]; 16
    canvas rows map to two 8-row plates."""
    header = ["PLATE NAME", "PLATE POSITION", "OLIGO NAME", "SEQUENCE"]
    if with_color:
        header = header + ["COLOR"]
    lookup = {row[0]: row for row in plate}
    out = [header]
    for r, prow in enumerate(_PLATE_ROWS):
        suffix = "_1" if r < 8 else "_2"
        for col in _PLATE_COLS:
            entry = lookup.get(_STRUCTURE_ROWS[r] + str(col))
            row_out = [platename + suffix, prow + str(col),
                       entry[1] if entry else " ",
                       entry[2] if entry else " "]
            if with_color:
                row_out.append(entry[3] if entry else " ")
            out.append(row_out)
    return out


def convertPlateIndex(plate: list, platename: str) -> list:
    """Canvas layout -> ordering plate list (picasso/design.py:21)."""
    return _convert(plate, platename, with_color=False)


def convertPlateIndexColor(plate: list, platename: str) -> list:
    """Canvas layout -> ordering plate list with colours
    (picasso/design.py:107)."""
    return _convert(plate, platename, with_color=True)


def readPlate(filename: str) -> list:
    """Read a plate CSV (picasso/design.py:196)."""
    with open(filename) as f:
        return list(csv.reader(f))


def savePlate(filename: str, data: list) -> None:
    """Write plate lists to CSV (picasso/design.py:215)."""
    with open(filename, "w", newline="") as f:
        writer = csv.writer(f, delimiter=",", quotechar="|",
                            quoting=csv.QUOTE_MINIMAL)
        for plate in data:
            for row in plate:
                writer.writerow(row)
