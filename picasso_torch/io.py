"""Movie and localization-table I/O of the port: raw movies with their
YAML info chain, and the HDF5 ``"locs"`` table.

Counterpart of picasso_tpu/io.py (load_info :48, save_info :60,
save_locs :81, load_locs :102, save_drift :282, load_raw :447,
load_movie :1472). The files written are byte-compatible with
picasso_tpu.io's. ``h5py`` and ``yaml`` are
imported inside the functions that need them, so the localize path
itself needs only numpy, torch and scipy.
"""

from __future__ import annotations

import os

import numpy as np

from picasso_torch import lib


class NoMetadataFileError(FileNotFoundError):
    pass


def load_info(path: str) -> list[dict]:
    """The YAML info chain next to a data file (picasso/io.py:375)."""
    import yaml

    filename = os.path.splitext(path)[0] + ".yaml"
    try:
        with open(filename, "r") as f:
            return list(yaml.load_all(f, Loader=yaml.UnsafeLoader))
    except FileNotFoundError as e:
        raise NoMetadataFileError(e)


def save_info(path: str, info: list[dict],
              default_flow_style: bool = False) -> None:
    """Write the YAML info chain as a multi-document stream."""
    import yaml

    with open(path, "w") as f:
        yaml.dump_all(info, f, default_flow_style=default_flow_style)


def load_raw(path: str):
    """A raw movie as a read-only memmap plus its info chain
    (picasso/io.py:50)."""
    info = load_info(path)
    dtype = np.dtype(info[0]["Data Type"])
    shape = (info[0]["Frames"], info[0]["Height"], info[0]["Width"])
    movie = np.memmap(path, dtype, "r", shape=shape)
    if info[0]["Byte Order"] != "<":
        movie = movie.byteswap()
        info[0]["Byte Order"] = "<"
    return movie, info


def load_movie(path: str):
    """Load a movie by extension. Only ``.raw`` is ported so far."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".raw":
        return load_raw(path)
    raise NotImplementedError(
        f"{ext} movies are not ported yet (ROADMAP queue 1 item 14: "
        "io); convert to .raw with `python -m picasso_tpu toraw`"
    )


def save_locs(path: str, locs: np.ndarray, info: list[dict]) -> None:
    """Save a locs structured array as the HDF5 ``"locs"`` dataset plus
    the YAML info chain; ``ensure_sanity`` runs first, like the
    reference (picasso/io.py:2089)."""
    import h5py

    locs = lib.ensure_sanity(locs, info)
    with h5py.File(path, "w") as f:
        f.create_dataset("locs", data=locs)
    save_info(os.path.splitext(path)[0] + ".yaml", info)


def load_locs(path: str):
    """A locs table (.hdf5 ``"locs"`` dataset) and its info chain, after
    ``ensure_sanity`` (picasso/io.py:2113)."""
    import h5py

    with h5py.File(path, "r") as f:
        if "locs" not in f:
            raise KeyError(f"File {path} does not contain a 'locs' dataset.")
        locs = f["locs"][()]
    info = load_info(path)
    return lib.ensure_sanity(locs, info), info


def save_drift(path: str, drift: np.ndarray) -> None:
    """Per-frame drift (fields x, y) as CRLF-terminated text, one row
    "x y" per frame (picasso/io.py:514)."""
    np.savetxt(path, np.column_stack([drift[n] for n in drift.dtype.names]),
               newline="\r\n")
