"""picasso_torch command-line interface.

Counterpart of picasso_tpu/__main__.py for the verbs ported so far:

    python -m picasso_torch localize movie.ome.tif [-d 1000] [-db]
        [-a mle|lq|lq-gpu|avg|mle-3d|lq-3d|lq-gpu-3d -zc calib.yaml]
        [--device cuda|cpu]
    python -m picasso_torch align a_locs.hdf5 b_locs.hdf5 [...]
    python -m picasso_torch toraw "*.tif"
    python -m picasso_torch undrift "*_locs.hdf5" [-s 1000 | -f drift.txt]
    python -m picasso_torch aim "*_locs.hdf5" [-s 100 -i 0.154 -r 0.462]
    python -m picasso_torch undrift_fiducials "*_locs.hdf5"
    python -m picasso_torch render "*_locs.hdf5" [-o 1 -b convolve -c hot]
    python -m picasso_torch link "*_locs.hdf5" [-d 1.0 -t 1]
    python -m picasso_torch dark "*_link.hdf5"
    python -m picasso_torch groupprops "*_dark.hdf5"
    python -m picasso_torch density "*_locs.hdf5" RADIUS
    python -m picasso_torch pc "*_locs.hdf5" [-b 0.1 -r 10]
    python -m picasso_torch nneighbor "*_clusters.hdf5"
    python -m picasso_torch clusterfilter "*.hdf5" PARAMETER MIN MAX
    python -m picasso_torch join a.hdf5 b.hdf5 [-k]
    python -m picasso_torch cluster_combine "*.hdf5"
    python -m picasso_torch cluster_combine_dist "*_comb.hdf5"
    python -m picasso_torch smlm_cluster "*_locs.hdf5" RADIUS MIN_LOCS
        [-z RADIUS_Z] [-f 0|1]
    python -m picasso_torch dbscan "*_locs.hdf5" RADIUS DENSITY
    python -m picasso_torch hdbscan "*_locs.hdf5" MIN_CLUSTER MIN_SAMPLES
    python -m picasso_torch g5m "*_dbscan.hdf5" [-m 10] [-zc calib.yaml]
    python -m picasso_torch spinna structures.yaml A_locs.hdf5 [B.hdf5 ...]
        [-g 11 -u 3 -l 1 -W WIDTH -H HEIGHT -n 1 -m coarse-to-fine]
    python -m picasso_torch spinna-batch parameters.csv [-b] [-v]
        [-m bayesian]
    python -m picasso_torch csv2hdf "*.csv" -p PIXELSIZE
    python -m picasso_torch hdf2csv|hdf2ts|hdf2imagej|hdf2nis|hdf2chimera|
        hdf2visp "*_locs.hdf5"
    python -m picasso_torch toims "*.tif" [--stacked]
    python -m picasso_torch server
    python -m picasso_torch filter|design|simulate|average|average3|
        nanotron|rotation

``server`` runs the Streamlit pages of picasso_torch/server/app.py (it
needs the optional ``streamlit`` package). The seven GUI verbs open
``design`` and ``simulate`` where there is a display and an interactive
matplotlib backend, and otherwise say how to run picasso_torch.gui's
apps from Python, as the JAX CLI does.

``localize`` reads .raw, .tif/.tiff series, .ims, .stk and .nd2 movies
and takes the JAX CLI's flags and defaults plus ``--device`` (default
``cuda``; without a card it raises rather than run on the CPU). The
``-3d`` methods fit z with the calibration YAML of ``-zc``. After saving
``<movie>_locs.hdf5`` it runs RCC drift correction with segments of
``-d`` frames (default 1000, 0 to skip), writing ``<movie>_locs_drift.txt``
and ``<movie>_locs_undrift.hdf5``, as the JAX CLI does; with ``-db`` it
then summarizes ``<movie>_locs.hdf5`` (column means and stds, NeNA,
event length, RCC drift) into the ``files`` table of
``~/.picasso/app_0410.db``. ``align`` aligns the channels of two or more
locs files by RCC and writes ``<base>_align.hdf5`` for each. ``toraw``
converts TIFF movies matching a pattern to .raw + .yaml, one file per
multi-file series. ``undrift`` (RCC, or ``-f`` a drift file), ``aim``
and ``undrift_fiducials`` correct the drift of saved locs files and
write ``<base>_undrift.hdf5`` (``_aim.hdf5`` for AIM) with the drift as
text beside it; ``render`` writes ``<base>.png`` through matplotlib.
``link`` (``_link.hdf5``), ``dark`` (``_dark.hdf5``), ``groupprops``
(``_groupprops.hdf5``, dataset ``groups``), ``density`` (``_density.hdf5``),
``pc`` (``_pc.csv``), ``nneighbor`` (``_nn.csv``), ``clusterfilter``
(``_filter.hdf5``), ``join`` (``<first>_join.hdf5``), ``cluster_combine``
(``_comb.hdf5``) and ``cluster_combine_dist`` (``_cdist.hdf5``) write the
JAX CLI's files with its info blocks and messages; so do the clusterers
``smlm_cluster`` (``_clustered.hdf5``, ``_cluster_centers.hdf5``),
``dbscan`` (``_dbscan.hdf5``, ``_dbscan_centers.hdf5``) and ``hdbscan``
(``_hdbscan.hdf5``, ``_hdbscan_centers.hdf5``), which need no sklearn.
``g5m`` maps the molecules of grouped locs (``_g5m.hdf5``, the
molecules; ``_g5m_locs.hdf5``, the locs labelled by molecule).
``spinna`` fits the stoichiometry of the structures of a YAML file to
one locs file a target and prints the best proportions and KS score;
``spinna-batch`` runs one fit a row of a parameters CSV into a new
``<parameters>__fitting_results`` folder.
``csv2hdf`` imports ThunderSTORM CSVs (``-p`` the pixel size, nm) as
``<base>.hdf5``; ``hdf2csv`` writes every field of a locs file as
``<base>.csv``; ``hdf2ts`` (``_ts.csv``), ``hdf2imagej`` (``_ij.txt``),
``hdf2nis`` (``_nis.txt``), ``hdf2chimera`` (``.xyz``) and ``hdf2visp``
(``.3d``) export for ThunderSTORM, ImageJ, NIS Elements, Chimera and
ViSP; ``toims`` writes a movie as Bitplane Imaris ``<base>.ims``. Every
verb after localize but ``toraw``, ``join``, ``clusterfilter``, these
conversions and ``toims`` takes ``--device`` too. ``localize --profile
DIR`` writes a torch.profiler trace (profiling.trace).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

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
        if args.database:
            localize.add_file_to_db(path, out, device=device)


def _undrift_rcc_single(path: str, segmentation, device, fromfile=None):
    """RCC undrift of a saved locs file, or the drift of ``fromfile``
    applied to it (picasso_tpu/__main__.py:166): ``<base>_undrift.hdf5``
    beside it, and for RCC ``<base>_drift.txt``. The info records
    ``segmentation`` as given."""
    from picasso_torch import io, postprocess

    locs, info = io.load_locs(path)
    if fromfile:
        locs = postprocess.apply_drift(locs, info,
                                       drift=io.load_drift(fromfile),
                                       device=device)
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


def _link(args):
    from picasso_torch import io, lib, postprocess

    device = lib.resolve_device(args.device)
    for path in _iter_files(args.files):
        locs, info = io.load_locs(path)
        linked = postprocess.link(locs, info, r_max=args.distance,
                                  max_dark_time=args.tolerance, device=device)
        new_info = info + [{"Generated by": "Picasso Link",
                            "Maximum distance": args.distance,
                            "Maximum transient dark time": args.tolerance}]
        out = _out_path(path, "_link")
        io.save_locs(out, linked, new_info)
        print(f"Linked {len(locs)} -> {len(linked)} events: {out}")


def _dark(args):
    from picasso_torch import io, lib, postprocess

    device = lib.resolve_device(args.device)
    for path in _iter_files(args.files):
        locs, info = io.load_locs(path)
        out_locs = postprocess.compute_dark_times(locs, device=device)
        out = _out_path(path, "_dark")
        io.save_locs(out, out_locs, info + [{"Generated by": "Picasso Dark"}])
        print(f"Dark times -> {out}")


def _nneighbor(args):
    import numpy as np

    from picasso_torch import io, lib, postprocess

    device = lib.resolve_device(args.device)
    for path in _iter_files(args.files):
        clusters = io.load_clusters(path)
        cols = ["x", "y"] + (["z"] if "z" in clusters.dtype.names else [])
        X = np.stack([clusters[c] for c in cols], 1)
        nn = postprocess.nn_analysis(X, X, 1, device=device)
        out = os.path.splitext(path)[0] + "_nn.csv"
        np.savetxt(out, nn, delimiter=",")
        print(f"Nearest neighbors -> {out}")


def _density(args):
    from picasso_torch import io, lib, postprocess

    device = lib.resolve_device(args.device)
    for path in _iter_files(args.files):
        locs, info = io.load_locs(path)
        locs = postprocess.compute_local_density(locs, info, args.radius,
                                                 device=device)
        out = _out_path(path, "_density")
        io.save_locs(out, locs, info + [{"Generated by": "Picasso Density"}])
        print(f"Density -> {out}")


def _clusterfilter(args):
    from picasso_torch import io

    for path in _iter_files(args.files):
        locs, info = io.load_locs(path)
        vals = locs[args.parameter]
        kept = locs[(vals >= args.minval) & (vals <= args.maxval)]
        out = _out_path(path, "_filter")
        io.save_locs(out, kept, info + [{
            "Generated by": "Picasso Filter", "Parameter": args.parameter,
            "Min": args.minval, "Max": args.maxval}])
        print(f"Filter {len(locs)} -> {len(kept)}: {out}")


def _align(args):
    from picasso_torch import io, lib, postprocess

    device = lib.resolve_device(args.device)
    paths = []
    for pattern in args.files:
        paths.extend(sorted(glob.glob(pattern)))
    if len(paths) < 2:
        print("align requires at least two files")
        return
    locs_list, infos = [], []
    for path in paths:
        locs, info = io.load_locs(path)
        locs_list.append(locs)
        infos.append(info)
    aligned = postprocess.align_rcc(locs_list, infos, device=device)
    for path, locs, info in zip(paths, aligned, infos):
        out = _out_path(path, "_align")
        io.save_locs(out, locs, info + [{"Generated by": "Picasso Align"}])
        print(f"Aligned -> {out}")


def _join(args):
    from picasso_torch import io, lib

    paths = []
    for pattern in args.files:
        paths.extend(sorted(glob.glob(pattern)))
    locs_list, infos = [], []
    for p in paths:
        locs, info = io.load_locs(p)
        locs_list.append(locs)
        infos.append(info)
    joined = lib.merge_locs(locs_list, increment_frames=not args.keep_frames)
    out = _out_path(paths[0], "_join")
    io.save_locs(out, joined, infos[0] + [{"Generated by": "Picasso Join"}])
    print(f"Joined {len(paths)} files -> {out}")


def _groupprops(args):
    from picasso_torch import io, lib, postprocess

    device = lib.resolve_device(args.device)
    for path in _iter_files(args.files):
        locs, info = io.load_locs(path)
        groups = postprocess.groupprops(locs, device=device)
        out = _out_path(path, "_groupprops")
        io.save_datasets(out, info, groups=groups)
        print(f"Group properties -> {out}")


def _pc(args):
    import numpy as np

    from picasso_torch import io, lib, postprocess

    device = lib.resolve_device(args.device)
    for path in _iter_files(args.files):
        locs, info = io.load_locs(path)
        bins, pc = postprocess.pair_correlation(locs, info, args.binsize,
                                                args.rmax, device=device)
        out = os.path.splitext(path)[0] + "_pc.csv"
        np.savetxt(out, np.column_stack([bins, pc]), delimiter=",")
        print(f"Pair correlation -> {out}")


def _cluster_combine(args):
    from picasso_torch import io, lib, postprocess

    device = lib.resolve_device(args.device)
    for path in _iter_files(args.files):
        locs, info = io.load_locs(path)
        combined = postprocess.cluster_combine(locs, device=device)
        out = _out_path(path, "_comb")
        io.save_locs(out, combined,
                     info + [{"Generated by": "Picasso Combine"}])
        print(f"Cluster combine -> {out}")


def _cluster_combine_dist(args):
    from picasso_torch import io, lib, postprocess

    device = lib.resolve_device(args.device)
    for path in _iter_files(args.files):
        locs, info = io.load_locs(path)
        px = None
        for block in info:
            if isinstance(block, dict) and "Pixelsize" in block:
                px = block["Pixelsize"]
        combined = postprocess.cluster_combine_dist(locs, px, device=device)
        out = _out_path(path, "_cdist")
        io.save_locs(out, combined,
                     info + [{"Generated by": "Picasso CombineDist"}])
        print(f"Cluster combine dist -> {out}")


def _clusterer_verb(args, run, suffix: str, centers_suffix: str,
                    message: str):
    """A clusterer verb: each file clustered by ``run(locs, pixelsize,
    device)`` (-> locs, info block), written to ``<base><suffix>.hdf5``
    with its cluster centers in ``<base><centers_suffix>.hdf5``."""
    from picasso_torch import clusterer, io, lib

    device = lib.resolve_device(args.device)
    for path in _iter_files(args.files):
        locs, info = io.load_locs(path)
        pixelsize = lib.get_from_metadata(info, "Pixelsize", 130)
        clustered, cinfo = run(locs, pixelsize, device)
        out = _out_path(path, suffix)
        io.save_locs(out, clustered, info + [cinfo])
        centers = clusterer.find_cluster_centers(clustered, pixelsize,
                                                 device=device)
        io.save_locs(_out_path(path, centers_suffix), centers,
                     info + [cinfo])
        print(f"{message} -> {out}")


def _dbscan(args):
    from picasso_torch import clusterer

    _clusterer_verb(args, lambda locs, px, device: clusterer.dbscan(
        locs, args.radius, args.density, pixelsize=px, return_info=True,
        device=device), "_dbscan", "_dbscan_centers", "DBSCAN")


def _hdbscan(args):
    from picasso_torch import clusterer

    _clusterer_verb(args, lambda locs, px, device: clusterer.hdbscan(
        locs, args.min_cluster, args.min_samples, pixelsize=px,
        return_info=True, device=device), "_hdbscan", "_hdbscan_centers",
        "HDBSCAN")


def _smlm_cluster(args):
    from picasso_torch import clusterer

    _clusterer_verb(args, lambda locs, px, device: clusterer.cluster(
        locs, radius_xy=args.radius, min_locs=args.min_locs,
        frame_analysis=bool(args.basic_fa), radius_z=args.radius_z,
        pixelsize=px, return_info=True, device=device), "_clustered",
        "_cluster_centers", "SMLM cluster")


def _g5m(args):
    from picasso_torch import g5m, io, lib

    device = lib.resolve_device(args.device)
    calibration = None
    if args.zc:
        import yaml

        with open(args.zc) as f:
            calibration = yaml.full_load(f)
    for path in _iter_files(args.files):
        locs, info = io.load_locs(path)
        centers, clustered, new_info = g5m.g5m(
            locs, info, min_locs=args.min_locs, calibration=calibration,
            callback_parent="console", device=device)
        io.save_locs(_out_path(path, "_g5m"), centers, new_info)
        io.save_locs(_out_path(path, "_g5m_locs"), clustered, new_info)
        print(f"G5M -> {_out_path(path, '_g5m')}")


def _spinna(args):
    import numpy as np

    from picasso_torch import io, lib, spinna

    device = lib.resolve_device(args.device)
    structures, targets = spinna.load_structures(args.structures)
    exp_data = {}
    for t, p in zip(targets, args.files):
        locs, _ = io.load_locs(p)
        px = 130
        exp_data[t] = np.column_stack([locs["x"] * px, locs["y"] * px])
    mixer = spinna.StructureMixer(
        structures, label_unc={"ALL": args.label_unc}, le={"ALL": args.le},
        width=args.width, height=args.height)
    N_total = {t: int(len(exp_data[t]) / args.le) for t in targets}
    space = spinna.generate_N_structures(structures, N_total,
                                         args.granularity)
    spin = spinna.SPINNA(mixer, exp_data, N_sim=args.nsim, device=device)
    props, score = spin.fit(space, fitting_mode=args.mode,
                            callback="console")[:2]
    print("SPINNA best fit:")
    for n, p in zip(mixer.get_structure_names(), np.atleast_1d(props)):
        print(f"  {n}: {p:.1f} %")
    print(f"KS score: {score:.4f}")


def _spinna_batch(args):
    from picasso_torch import spinna

    summary = spinna.batch_analysis(
        args.parameters, bootstrap=args.bootstrap, verbose=args.verbose,
        fitting_mode=args.mode, device=args.device)
    columns = list(dict.fromkeys(k for row in summary for k in row))
    print("  ".join(columns))
    for row in summary:
        print("  ".join(str(row.get(c, "")) for c in columns))


def _toims(args):
    from picasso_torch import io

    for path in sorted(glob.glob(args.files)):
        movie, info = io.load_movie(path)
        out = os.path.splitext(path)[0] + ".ims"
        io.write_ims(out, movie[:], info, stacked=args.stacked)
        print(f"Wrote {out}")


def _csv2hdf(args):
    from picasso_torch import io

    for path in _iter_files(args.files):
        locs, info = io.import_ts(path, pixelsize=args.pixelsize)
        out = os.path.splitext(path)[0] + ".hdf5"
        io.save_locs(out, locs, info)
        print(f"Imported -> {out}")


def _hdf2csv(args):
    from picasso_torch import io, lib

    for path in _iter_files(args.files):
        locs, _ = io.load_locs(path)
        out = os.path.splitext(path)[0] + ".csv"
        lib.write_table(out, {n: locs[n] for n in locs.dtype.names})
        print(f"Exported -> {out}")


# the exporting verbs: (io function, output suffix, label, help)
_EXPORTS = {
    "hdf2ts": ("export_ts", "_ts.csv", "ThunderSTORM",
               "export to ThunderSTORM csv"),
    "hdf2imagej": ("export_txt_imagej", "_ij.txt", "ImageJ",
                   "export to ImageJ txt"),
    "hdf2nis": ("export_txt_nis", "_nis.txt", "NIS",
                "export to NIS Elements txt"),
    "hdf2chimera": ("export_xyz_chimera", ".xyz", "Chimera",
                    "export to Chimera xyz"),
    "hdf2visp": ("export_3d_visp", ".3d", "ViSP", "export to ViSP 3d"),
}


def _export(args):
    from picasso_torch import io

    name, ext, label, _ = _EXPORTS[args.command]
    for path in _iter_files(args.files):
        locs, info = io.load_locs(path)
        out = os.path.splitext(path)[0] + ext
        getattr(io, name)(out, locs, info)
        print(f"Exported ({label}) -> {out}")


def _server(args):
    import subprocess

    app = os.path.join(os.path.dirname(os.path.abspath(__file__)), "server",
                       "app.py")
    subprocess.run([sys.executable, "-m", "streamlit", "run", app])


_GUI_VERBS = ("filter", "design", "simulate", "average", "average3",
              "nanotron", "rotation")


def _gui_stub(args):
    """Open the matplotlib app of a GUI verb where there is a display and
    an interactive backend; otherwise say how to run the apps from
    Python (picasso_tpu/__main__.py:626)."""
    launchers = {
        "design": lambda gui: gui.DesignApp(),
        "simulate": lambda gui: gui.SimulateApp(),
    }
    has_display = (sys.platform in ("darwin", "win32")
                   or bool(os.environ.get("DISPLAY"))
                   or bool(os.environ.get("WAYLAND_DISPLAY")))
    interactive = False
    if has_display:
        try:
            import matplotlib
            import matplotlib.pyplot as plt

            interactive = matplotlib.get_backend().lower() != "agg"
        except Exception:
            interactive = False
    launcher = launchers.get(args.command)
    if interactive and launcher is not None:
        from picasso_torch import gui

        launcher(gui)
        plt.show()
        return
    print(
        f"'{args.command}' runs from python: picasso_torch.gui provides "
        "RenderApp / LocalizeApp / FilterApp / RotationApp / AverageApp / "
        "Average3App / SimulateApp / DesignApp / SpinnaApp / NanotronApp / "
        "ToRawApp (matplotlib, any backend). All processing is also "
        "available headlessly through this CLI, and outputs are "
        "file-compatible with the reference Picasso GUI."
    )


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
        "toims", help="convert movies into Bitplane Imaris .ims")
    p.add_argument("files", help="path pattern of movie files")
    p.add_argument("--stacked", action="store_true",
                   help="write all frames as one z-stack TimePoint")
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

    p = subparsers.add_parser(
        "link", help="link localizations in consecutive frames")
    p.add_argument("files")
    p.add_argument("-d", "--distance", type=float, default=1.0)
    p.add_argument("-t", "--tolerance", type=int, default=1)
    _device_arg(p)

    p = subparsers.add_parser(
        "dark", help="compute dark times for linked localizations")
    p.add_argument("files")
    _device_arg(p)

    p = subparsers.add_parser(
        "nneighbor", help="nearest neighbors of clustered data")
    p.add_argument("files", nargs="?")
    _device_arg(p)

    p = subparsers.add_parser("density", help="local density computation")
    p.add_argument("files")
    p.add_argument("radius", type=float)
    _device_arg(p)

    p = subparsers.add_parser(
        "clusterfilter", help="filter locs by a parameter range")
    p.add_argument("files")
    p.add_argument("parameter")
    p.add_argument("minval", type=float)
    p.add_argument("maxval", type=float)

    p = subparsers.add_parser("align", help="align channels by RCC")
    p.add_argument("files", nargs="+")
    _device_arg(p)

    p = subparsers.add_parser("join", help="join hdf5 files")
    p.add_argument("files", nargs="+")
    p.add_argument("-k", "--keep-frames", action="store_true")

    p = subparsers.add_parser("groupprops", help="per-group statistics")
    p.add_argument("files")
    _device_arg(p)

    p = subparsers.add_parser("pc", help="pair correlation")
    p.add_argument("files")
    p.add_argument("-b", "--binsize", type=float, default=0.1)
    p.add_argument("-r", "--rmax", type=float, default=10.0)
    _device_arg(p)

    p = subparsers.add_parser(
        "cluster_combine", help="combine clustered localizations")
    p.add_argument("files")
    _device_arg(p)

    p = subparsers.add_parser(
        "cluster_combine_dist",
        help="combine clusters + nearest cluster distances")
    p.add_argument("files")
    _device_arg(p)

    p = subparsers.add_parser("dbscan", help="DBSCAN clustering")
    p.add_argument("files")
    p.add_argument("radius", type=float)
    p.add_argument("density", type=int)
    _device_arg(p)

    p = subparsers.add_parser("hdbscan", help="HDBSCAN clustering")
    p.add_argument("files")
    p.add_argument("min_cluster", type=int)
    p.add_argument("min_samples", type=int)
    _device_arg(p)

    p = subparsers.add_parser("smlm_cluster", help="SMLM clustering")
    p.add_argument("files")
    p.add_argument("radius", type=float)
    p.add_argument("min_locs", type=int)
    p.add_argument("-z", "--radius-z", type=float, default=None)
    p.add_argument("-f", "--basic-fa", type=int, default=0)
    _device_arg(p)

    p = subparsers.add_parser(
        "g5m", help="G5M molecular mapping (constrained GMM)")
    p.add_argument("files")
    p.add_argument("-m", "--min-locs", type=int, default=10)
    p.add_argument("-zc", "--zc", type=str, default="")
    _device_arg(p)

    modes = ["coarse-to-fine", "bayesian", "brute-force"]
    p = subparsers.add_parser("spinna", help="SPINNA stoichiometry fitting")
    p.add_argument("structures", help="structures .yaml file")
    p.add_argument("files", nargs="+", help="one locs file per target")
    p.add_argument("-g", "--granularity", type=int, default=11)
    p.add_argument("-u", "--label-unc", type=float, default=3.0)
    p.add_argument("-l", "--le", type=float, default=1.0)
    p.add_argument("-W", "--width", type=float, default=None)
    p.add_argument("-H", "--height", type=float, default=None)
    p.add_argument("-n", "--nsim", type=int, default=1)
    p.add_argument("-m", "--mode", choices=modes, default="coarse-to-fine")
    _device_arg(p)

    p = subparsers.add_parser(
        "spinna-batch", help="SPINNA batch analysis from a CSV parameters "
        "file (one fit per row; LE fitting rows supported)")
    p.add_argument("parameters", help="parameters .csv file")
    p.add_argument("-b", "--bootstrap", action="store_true",
                   help="bootstrap SEMs")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="per-row console progress")
    p.add_argument("-m", "--mode", choices=modes, default="bayesian")
    _device_arg(p)

    p = subparsers.add_parser("csv2hdf", help="import ThunderSTORM csv")
    p.add_argument("files")
    p.add_argument("-p", "--pixelsize", type=float, required=True,
                   help="camera pixel size in nm")
    p = subparsers.add_parser("hdf2csv", help="export to csv")
    p.add_argument("files")
    for name, (*_, helptext) in _EXPORTS.items():
        p = subparsers.add_parser(name, help=helptext)
        p.add_argument("files")

    subparsers.add_parser("server", help="monitoring server (streamlit)")
    for verb in _GUI_VERBS:
        subparsers.add_parser(verb, help=f"{verb} (GUI app)")

    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return
    verbs = {"toraw": _toraw, "toims": _toims, "render": _render,
             "undrift": _undrift,
             "aim": _aim, "undrift_fiducials": _undrift_fiducials,
             "link": _link, "dark": _dark, "nneighbor": _nneighbor,
             "density": _density, "clusterfilter": _clusterfilter,
             "align": _align, "join": _join, "groupprops": _groupprops,
             "pc": _pc,
             "cluster_combine": _cluster_combine,
             "cluster_combine_dist": _cluster_combine_dist,
             "dbscan": _dbscan, "hdbscan": _hdbscan,
             "smlm_cluster": _smlm_cluster, "g5m": _g5m,
             "spinna": _spinna, "spinna-batch": _spinna_batch,
             "csv2hdf": _csv2hdf, "hdf2csv": _hdf2csv,
             **dict.fromkeys(_EXPORTS, _export), "server": _server,
             **dict.fromkeys(_GUI_VERBS, _gui_stub)}
    from picasso_torch import profiling

    with profiling.trace(getattr(args, "profile", None)):
        if args.command in verbs:
            verbs[args.command](args)
        else:
            _localize(args, localize_parser)


def _device_arg(p) -> None:
    p.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda); cpu runs the plain PyTorch "
        "versions of the kernels",
    )


if __name__ == "__main__":
    main()
