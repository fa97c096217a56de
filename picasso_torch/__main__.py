"""picasso_torch command-line interface.

Counterpart of picasso_tpu/__main__.py for the verbs ported so far:

    python -m picasso_torch localize movie.ome.tif [-d 1000]
        [-a mle|lq|lq-gpu|avg|mle-3d|lq-3d|lq-gpu-3d -zc calib.yaml]
        [--device cuda|cpu]
    python -m picasso_torch toraw "*.tif"
    python -m picasso_torch undrift "*_locs.hdf5" [-s 1000 | -f drift.txt]
    python -m picasso_torch aim "*_locs.hdf5" [-s 100 -i 0.154 -r 0.462]
    python -m picasso_torch undrift_fiducials "*_locs.hdf5"
    python -m picasso_torch render "*_locs.hdf5" [-o 1 -b convolve -c hot]

``localize`` reads .raw, .tif/.tiff series, .ims, .stk and .nd2 movies
and takes the JAX CLI's flags and defaults plus ``--device`` (default
``cuda``; without a card it raises rather than run on the CPU). The
``-3d`` methods fit z with the calibration YAML of ``-zc``. After saving
``<movie>_locs.hdf5`` it runs RCC drift correction with segments of
``-d`` frames (default 1000, 0 to skip), writing ``<movie>_locs_drift.txt``
and ``<movie>_locs_undrift.hdf5``, as the JAX CLI does. ``toraw``
converts TIFF movies matching a pattern to .raw + .yaml, one file per
multi-file series. ``undrift`` (RCC, or ``-f`` a drift file), ``aim``
and ``undrift_fiducials`` correct the drift of saved locs files and
write ``<base>_undrift.hdf5`` (``_aim.hdf5`` for AIM) with the drift as
text beside it; ``render`` writes ``<base>.png`` through matplotlib. The
post-localize verbs take ``--device`` too.
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


def _iter_files(pattern: str) -> list[str]:
    paths = sorted(glob.glob(pattern))
    if not paths:
        print(f"No files matching {pattern}")
    return paths


def _out_path(path: str, suffix: str) -> str:
    return os.path.splitext(path)[0] + suffix + ".hdf5"


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
    for path in _iter_files(args.files):
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
        out = _out_path(path, "_locs" + args.suffix)
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


def _undrift_rcc_single(path: str, segmentation, device, fromfile=None):
    """RCC undrift of a saved locs file, or the drift of ``fromfile``
    applied to it (picasso_tpu/__main__.py:166): ``<base>_undrift.hdf5``
    beside it, and for RCC ``<base>_drift.txt``. The info records
    ``segmentation`` as given."""
    from picasso_torch import io, postprocess

    locs, info = io.load_locs(path)
    if fromfile:
        locs = postprocess.apply_drift(locs, info,
                                       drift=io.load_drift(fromfile))
        new_info = info + [{"Generated by": "Picasso Undrift (from file)"}]
    else:
        drift, locs = postprocess.undrift(locs, info, int(segmentation),
                                          device=device)
        io.save_drift(os.path.splitext(path)[0] + "_drift.txt", drift)
        new_info = info + [{"Generated by": "Picasso Undrift RCC",
                            "Segmentation": segmentation}]
    out = _out_path(path, "_undrift")
    io.save_locs(out, locs, new_info)
    print(f"Undrifted -> {out}")


def _undrift(args):
    from picasso_torch import lib

    device = lib.resolve_device(args.device)
    for path in _iter_files(args.files):
        _undrift_rcc_single(path, args.segmentation, device, args.fromfile)


def _aim(args):
    from picasso_torch import aim, io, lib

    device = lib.resolve_device(args.device)
    for path in _iter_files(args.files):
        locs, info = io.load_locs(path)
        locs, new_info, drift = aim.aim(
            locs, info, segmentation=int(args.segmentation),
            intersect_d=args.intersectdist, roi_r=args.roiradius,
            device=device)
        io.save_drift(os.path.splitext(path)[0] + "_aimdrift.txt", drift)
        out = _out_path(path, "_aim")
        io.save_locs(out, locs, new_info)
        print(f"AIM undrifted -> {out}")


def _undrift_fiducials(args):
    from picasso_torch import io, lib, postprocess

    device = lib.resolve_device(args.device)
    for path in _iter_files(args.files):
        locs, info = io.load_locs(path)
        locs, new_info, drift = postprocess.undrift_from_fiducials(
            locs, info, device=device)
        io.save_drift(os.path.splitext(path)[0] + "_fiducialdrift.txt",
                      drift)
        out = _out_path(path, "_undrift")
        io.save_locs(out, locs, new_info)
        print(f"Fiducial undrifted -> {out}")


def _render(args):
    from picasso_torch import io, lib, render

    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the render verb writes its PNG with matplotlib, "
                          "which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    device = lib.resolve_device(args.device)
    for path in _iter_files(args.files):
        locs, info = io.load_locs(path)
        _, image = render.render(
            locs, info, oversampling=args.oversampling,
            blur_method=None if args.blur_method == "none"
            else args.blur_method, device=device)
        out = os.path.splitext(path)[0] + ".png"
        plt.imsave(out, render.scale_contrast(image, autoscale=True),
                   cmap=args.cmap, vmin=0, vmax=1)
        print(f"Rendered {path} -> {out}")


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
    _device_arg(p)
    localize_parser = p

    p = subparsers.add_parser(
        "render", help="render localization based images"
    )
    p.add_argument("files", nargs="?")
    p.add_argument("-o", "--oversampling", type=float, default=1.0)
    p.add_argument(
        "-b", "--blur-method",
        choices=["none", "convolve", "gaussian", "gaussian_iso", "smooth"],
        default="convolve",
    )
    p.add_argument("-c", "--cmap", default="hot")
    _device_arg(p)

    p = subparsers.add_parser("undrift", help="drift correction by RCC")
    p.add_argument("files")
    p.add_argument("-s", "--segmentation", type=float, default=1000)
    p.add_argument("-f", "--fromfile", type=str)
    p.add_argument("-d", "--display", action="store_true",
                   help="accepted and ignored (no display)")
    _device_arg(p)

    p = subparsers.add_parser("aim", help="drift correction by AIM")
    p.add_argument("files")
    p.add_argument("-s", "--segmentation", type=float, default=100)
    p.add_argument("-i", "--intersectdist", type=float, default=20 / 130)
    p.add_argument("-r", "--roiradius", type=float, default=60 / 130)
    _device_arg(p)

    p = subparsers.add_parser(
        "undrift_fiducials", help="drift correction from fiducials"
    )
    p.add_argument("files")
    _device_arg(p)

    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return
    verbs = {"toraw": _toraw, "render": _render, "undrift": _undrift,
             "aim": _aim, "undrift_fiducials": _undrift_fiducials}
    if args.command in verbs:
        verbs[args.command](args)
        return
    with _profile(args.profile):
        _localize(args, localize_parser)


def _device_arg(p) -> None:
    p.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda); cpu runs the plain PyTorch "
        "versions of the kernels",
    )


if __name__ == "__main__":
    main()
