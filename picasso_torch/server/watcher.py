"""Folder watcher: poll a directory for new movies, wait until their
writes end, and localize them (picasso_tpu/server/watcher.py:13-144;
picasso/server/watcher.py check_new :24, wait_for_change :70). The
localize runs on ``device``, the card by default: ``watch`` checks the
device once before its first poll and raises without a card, and no
movie is moved to another device."""

from __future__ import annotations

import os
import time
from datetime import datetime

FILETYPES = (".raw", ".ome.tif", ".tif", ".tiff", ".nd2", ".ims")


def print_to_file(logfile: str | None, message) -> None:
    if logfile:
        with open(logfile, "a") as f:
            f.write(f"{message}\n")


def check_new(path: str, processed: dict, logfile: str | None = None):
    """Files in ``path`` with a movie extension that are not processed
    yet and have no ``_locs.hdf5`` sibling (picasso/server/watcher.py:24).
    Returns (new files, processed)."""
    all_ = [os.path.join(path, f) for f in os.listdir(path)]
    new = [f for f in all_
           if os.path.normpath(f) not in processed and f.endswith(FILETYPES)]
    locs = [f for f in all_ if f.endswith("_locs.hdf5")]
    print_to_file(
        logfile,
        f"{datetime.now()} Checking: {len(all_)} files, {len(new)}"
        f" unprocessed, {len(locs)} _locs.hdf5 files in {path}.")
    still_new = []
    for f in new:
        stem = os.path.splitext(os.path.splitext(f)[0])[0]
        if any(os.path.splitext(ref)[0].startswith(stem) for ref in locs):
            processed[os.path.normpath(f)] = True
        else:
            still_new.append(f)
    return still_new, processed


def wait_for_change(file: str, poll_s: float = 2.0) -> None:
    """Block until the file's size stops changing
    (picasso/server/watcher.py:70)."""
    filesize = os.path.getsize(file)
    while True:
        time.sleep(poll_s)
        new_size = os.path.getsize(file)
        if new_size == filesize:
            return
        filesize = new_size


def process_file(file: str, localize_kwargs: dict | None = None,
                 logfile: str | None = None, device="cuda") -> str | None:
    """Localize one movie (MLE, the watcher's settings updated from
    ``localize_kwargs``) on ``device`` and save its ``_locs.hdf5``. A
    movie that fails is logged as FAILED and gives None, so that the
    watcher keeps watching."""
    from picasso_torch import io, localize

    kwargs = {"Min. Net Gradient": 5000, "Box Size": 7}
    camera_info = {"Baseline": 0, "Sensitivity": 1, "Gain": 1,
                   "Pixelsize": 130}
    for settings in (kwargs, camera_info):
        settings.update({k: v for k, v in (localize_kwargs or {}).items()
                         if k in settings})
    try:
        movie, info = io.load_movie(file)
        locs, new_info = localize.localize(
            movie, camera_info, kwargs, movie_info=info,
            fitting_method="gaussmle", return_info=True, device=device)
        out = os.path.splitext(file)[0] + "_locs.hdf5"
        io.save_locs(out, locs, new_info)
        print_to_file(logfile, f"{datetime.now()} Processed {file} -> "
                      f"{out} ({len(locs)} locs)")
        return out
    except Exception as e:  # keep watching even if one file fails
        print_to_file(logfile, f"{datetime.now()} FAILED {file}: {e}")
        return None


def watch(path: str, localize_kwargs: dict | None = None,
          logfile: str | None = None, poll_s: float = 10.0,
          max_iterations: int | None = None, device="cuda") -> None:
    """Poll ``path`` forever (or ``max_iterations`` times) and localize
    every new movie on ``device``."""
    from picasso_torch import lib

    lib.resolve_device(device)
    processed: dict = {}
    iteration = 0
    while max_iterations is None or iteration < max_iterations:
        new, processed = check_new(path, processed, logfile)
        for f in new:
            wait_for_change(f)
            process_file(f, localize_kwargs, logfile, device=device)
            processed[os.path.normpath(f)] = True
        iteration += 1
        if max_iterations is None or iteration < max_iterations:
            time.sleep(poll_s)
