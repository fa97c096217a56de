"""picasso_torch command-line interface.

Counterpart of picasso_tpu/__main__.py for the verbs ported so far:

    python -m picasso_torch localize movie.ome.tif [-d 1000]
        [-a mle|lq|lq-gpu|avg|mle-3d|lq-3d|lq-gpu-3d -zc calib.yaml]
        [--device cuda|cpu]
    python -m picasso_torch toraw "*.tif"

``localize`` reads .raw, .tif/.tiff series, .ims, .stk and .nd2 movies
and takes the JAX CLI's flags and defaults plus ``--device`` (default
``cuda``; without a card it raises rather than run on the CPU). The
``-3d`` methods fit z with the calibration YAML of ``-zc``. After saving
``<movie>_locs.hdf5`` it runs RCC drift correction with segments of
``-d`` frames (default 1000, 0 to skip), writing ``<movie>_locs_drift.txt``
and ``<movie>_locs_undrift.hdf5``, as the JAX CLI does. ``toraw``
converts TIFF movies matching a pattern to .raw + .yaml, one file per
multi-file series.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import os

# -a choices to localize's fitting_method (picasso_tpu/__main__.py:69-77)
_METHOD_MAP = {"mle": "gaussmle", "lq": "gausslq", "lq-gpu": "gausslq-gpu",
               "avg": "avg", "lq-3d": "gausslq", "lq-gpu-3d": "gausslq-gpu",
               "mle-3d": "gaussmle"}


def _toraw(args):
    from picasso_torch import io

    io.to_raw(args.files)


def _localize(args, parser):
    if args.database:
        parser.error(
            "-db is not ported yet (ROADMAP queue 1 item 14: server)"
        )
    if args.files is None:
        parser.error("localize needs a movie file or pattern")
    is_3d = args.fit_method.endswith("-3d")
    if is_3d and not args.zc:
        parser.error(f"-a {args.fit_method} needs a calibration: -zc FILE")

    from picasso_torch import io, lib, localize, postprocess

    device = lib.resolve_device(args.device)
    camera_info = {
        "Baseline": args.baseline,
        "Sensitivity": args.sensitivity,
        "Gain": args.gain,
        "Qe": args.qe,
        "Pixelsize": args.pixelsize,
    }
    roi = None
    if args.roi is not None:
        y0, x0, y1, x1 = args.roi
        roi = ((y0, x0), (y1, x1))
    frame_bounds = tuple(args.frame_bounds) if args.frame_bounds else None
    paths = sorted(glob.glob(args.files))
    if not paths:
        print(f"No files matching {args.files}")
    for path in paths:
        print(f"Localizing {path}")
        movie, info = io.load_movie(path)
        kw = dict(roi=roi, frame_bounds=frame_bounds, movie_info=info,
                  fitting_method=_METHOD_MAP[args.fit_method],
                  identification_progress_callback="console",
                  fit_progress_callback="console", device=device)
        if is_3d:
            locs, new_info = localize.localize_3D(
                movie, camera_info=camera_info, box=args.box_side_length,
                minimum_ng=args.gradient, calibration_3d=args.zc, **kw)
        else:
            locs, new_info = localize.localize(
                movie, camera_info, {"Min. Net Gradient": args.gradient,
                                     "Box Size": args.box_side_length},
                return_info=True, **kw)
        out = os.path.splitext(path)[0] + "_locs" + args.suffix + ".hdf5"
        io.save_locs(out, locs, new_info)
        print(f"Saved {len(locs)} locs to {out}")
        if args.drift > 0:
            # The JAX CLI prints every exception of its undrift and goes
            # on; the port only the movie shorter than two segments, so
            # that a fault of the card cannot end in exit 0.
            try:
                postprocess.n_segments(new_info, args.drift)
            except ValueError as e:
                print(f"RCC undrift failed: {e}")
            else:
                _undrift_rcc_single(out, args.drift, device)


def _undrift_rcc_single(path: str, segmentation: int, device):
    """RCC undrift of a saved locs file (picasso_tpu/__main__.py:166):
    ``<base>_drift.txt`` and ``<base>_undrift.hdf5`` beside it."""
    from picasso_torch import io, postprocess

    locs, info = io.load_locs(path)
    drift, locs = postprocess.undrift(locs, info, segmentation,
                                      device=device)
    base = os.path.splitext(path)[0]
    io.save_drift(base + "_drift.txt", drift)
    new_info = info + [{"Generated by": "Picasso Undrift RCC",
                        "Segmentation": segmentation}]
    out = base + "_undrift.hdf5"
    io.save_locs(out, locs, new_info)
    print(f"Undrifted -> {out}")


@contextlib.contextmanager
def _profile(trace_dir: str | None):
    """torch.profiler trace of the command into ``trace_dir``."""
    if not trace_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def main(argv=None):
    parser = argparse.ArgumentParser(
        "picasso-torch",
        description="PyTorch/CUDA port of picasso_tpu (SMLM / DNA-PAINT)",
    )
    subparsers = parser.add_subparsers(dest="command")
    p = subparsers.add_parser(
        "toraw", help="convert TIFF movies into raw format"
    )
    p.add_argument("files", help="path pattern of movie files")
    p = subparsers.add_parser(
        "localize", help="identify and fit single molecule spots"
    )
    p.add_argument("files", nargs="?", help="movie file or pattern")
    p.add_argument("-b", "--box-side-length", type=int, default=7)
    p.add_argument(
        "-a",
        "--fit-method",
        choices=[
            "mle", "lq", "lq-gpu", "lq-3d", "lq-gpu-3d", "mle-3d", "avg",
        ],
        default="mle",
    )
    p.add_argument("-g", "--gradient", type=int, default=5000)
    p.add_argument(
        "--profile", metavar="DIR",
        help="write a torch.profiler trace of the run into DIR",
    )
    p.add_argument(
        "-d", "--drift", type=int, default=1000,
        help="RCC segmentation, 0 to deactivate",
    )
    p.add_argument("-r", "--roi", type=int, nargs=4, default=None)
    p.add_argument("-fb", "--frame-bounds", type=int, nargs=2, default=None)
    p.add_argument("-bl", "--baseline", type=int, default=0)
    p.add_argument("-s", "--sensitivity", type=float, default=1)
    p.add_argument("-ga", "--gain", type=int, default=1)
    p.add_argument("-qe", "--qe", type=float, default=1)
    p.add_argument("-mf", "--mf", type=float, default=0)
    p.add_argument("-px", "--pixelsize", type=int, default=130)
    p.add_argument("-zc", "--zc", type=str, default="")
    p.add_argument("-sf", "--suffix", type=str, default="")
    p.add_argument("-db", "--database", action="store_true")
    p.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda); cpu runs the plain PyTorch "
        "versions of the kernels",
    )
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return
    if args.command == "toraw":
        _toraw(args)
        return
    with _profile(args.profile):
        _localize(args, p)


if __name__ == "__main__":
    main()
