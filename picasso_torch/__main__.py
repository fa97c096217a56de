"""picasso_torch command-line interface.

Counterpart of picasso_tpu/__main__.py for the verbs ported so far:

    python -m picasso_torch localize movie.raw -d 0 [-a mle|lq|lq-gpu]
        [--device cuda|cpu]

``localize`` takes the JAX CLI's flags and defaults plus ``--device``
(default ``cuda``; without a card it raises rather than run on the CPU).
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import os

# -a choices to localize's fitting_method (picasso_tpu/__main__.py:69-77);
# avg and the -3d methods are not ported yet
_METHOD_MAP = {"mle": "gaussmle", "lq": "gausslq", "lq-gpu": "gausslq-gpu"}
_UNDRIFT_TODO = (
    "RCC undrift (-d/--drift > 0) is not ported yet (ROADMAP queue 1, "
    "next: RCC undrift for the CLI default -d 1000); pass -d 0"
)


def _localize(args, parser):
    if args.drift > 0:
        parser.error(_UNDRIFT_TODO)
    if args.fit_method not in _METHOD_MAP:
        parser.error(
            f"-a {args.fit_method} is not ported yet (ROADMAP queue 1 "
            "items 4 and 8); use -a mle, lq or lq-gpu"
        )
    if args.database:
        parser.error(
            "-db is not ported yet (ROADMAP queue 1 item 14: server)"
        )
    if args.files is None:
        parser.error("localize needs a movie file or pattern")

    from picasso_torch import io, lib, localize

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
        locs, new_info = localize.localize(
            movie,
            camera_info,
            {
                "Min. Net Gradient": args.gradient,
                "Box Size": args.box_side_length,
            },
            roi=roi,
            frame_bounds=frame_bounds,
            movie_info=info,
            fitting_method=_METHOD_MAP[args.fit_method],
            identification_progress_callback="console",
            fit_progress_callback="console",
            return_info=True,
            device=device,
        )
        out = os.path.splitext(path)[0] + "_locs" + args.suffix + ".hdf5"
        io.save_locs(out, locs, new_info)
        print(f"Saved {len(locs)} locs to {out}")


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
    with _profile(args.profile):
        _localize(args, p)


if __name__ == "__main__":
    main()
