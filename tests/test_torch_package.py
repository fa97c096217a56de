"""picasso_torch as a package: it and chip_smoke.py never import JAX,
picasso_tpu, the JAX package's bench, pandas, sklearn or skimage, its kernels
build only from source with nvcc, and its kernel wrappers never fall
back to the plain versions for a tensor that is not on the CPU."""

from __future__ import annotations

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
import picasso_torch
import torch_data
from picasso_torch import _build, localize
from picasso_torch.ops import (
    identify_cuda, link, lq_cuda, mle_cuda, winfit_cuda,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# a Streamlit script: it raises ImportError without streamlit, so it is
# checked by its source (test_server_app_is_checked_by_source)
SCRIPTS = ("picasso_torch.server.app",)


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            picasso_torch.__path__, "picasso_torch."
        ) if m.name not in SCRIPTS
    )


def _smoke_imports() -> list[str]:
    """Every module chip_smoke.py imports, at any depth of its code."""
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module)
    return names


def test_every_module_imports_without_jax():
    mods = _modules()
    for m in ("ops.mle_cuda", "ops.lq_cuda", "ops.winfit_cuda",
              "ops.render_ops", "render", "imageprocess", "postprocess",
              "io", "stream", "avgroi", "zfit", "aim", "ops.neighbors",
              "ops.link", "masking", "clusterer", "ops.cluster", "g5m",
              "ops.gmm", "average", "spinna", "ops.spinna_batch",
              "nanotron", "average3", "simulate", "spatial_index",
              "profiling", "parallel", "parallel.mesh", "parallel.dryrun",
              "design", "design_sequences", "updater", "server",
              "server.db", "server.watcher", "gui", "gui.base", "gui.apps",
              "gui.plugins"):
        assert "picasso_torch." + m in mods
    from picasso_torch import io, lib, masking, postprocess

    for module, names in ((postprocess, (
            "pick_similar", "remove_locs_in_picks", "combine_locs_in_picks",
            "evaluate_picks", "pick_kinetics", "pick_properties",
            "calculate_fret", "plot_drift", "link_loc_groups")),
            (masking, ("mask_locs", "generate_image", "mask_image",
                       "THRESHOLD_METHODS", "threshold_yen")),
            (lib, ("pick_areas", "estimate_kinetic_rate",
                   "unfold_localizations_square", "AutoDict",
                   "append_to_rec", "remove_from_rec",
                   "calculate_optimal_bins", "hist2d", "hist2d_numba",
                   "extract_filter_steps", "apply_filter_steps",
                   "locs_glob_map", "REQUIRED_COLUMNS", "is_path_available",
                   "unpack_calibration")),
            (io, ("load_picks", "save_picks"))):
        for name in names:
            assert hasattr(module, name), (module.__name__, name)
    smoke = _smoke_imports()
    assert "torch_data" in smoke and "torch_parity" in smoke
    top = {m.split(".")[0] for m in smoke}
    assert not top & {"jax", "jaxlib", "picasso_tpu", "bench", "pandas",
                      "sklearn", "skimage"}, smoke
    code = (
        "import importlib, sys\n"
        f"for m in {mods + smoke!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'bench', 'pandas', "
        "'sklearn', 'skimage') or m.startswith(('jax.', 'jaxlib', "
        "'picasso_tpu', 'pandas.', 'sklearn.', 'skimage.'))]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
    )
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_clusterer_imports_no_jax_pandas_or_sklearn():
    """picasso_torch.clusterer (DBSCAN and HDBSCAN without sklearn) and
    its verbs' module, imported alone, pull in none of jax, picasso_tpu,
    pandas or sklearn."""
    code = (
        "import sys, picasso_torch.clusterer, picasso_torch.__main__\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'jaxlib', 'picasso_tpu', 'pandas', 'sklearn')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", ["g5m", "ops.gmm", "average", "spinna",
                                    "ops.spinna_batch", "ops.neighbors"])
def test_analysis_module_imports_no_jax_pandas_or_sklearn(module):
    """picasso_torch.g5m, .ops.gmm, .average, .spinna (with its Gaussian
    process), .ops.spinna_batch and .ops.neighbors (knn_masked,
    ks_2samp_masked), each imported alone, pull in none of jax,
    picasso_tpu, pandas or sklearn."""
    code = (
        f"import sys, picasso_torch.{module}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'jaxlib', 'picasso_tpu', 'pandas', 'sklearn')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", ["nanotron", "average3", "simulate"])
def test_workflow_module_imports_no_jax_flax_optax_pandas_or_sklearn(module):
    """picasso_torch.nanotron (the MLP, Adam and the model files),
    .average3 and .simulate, each imported alone and with a model loaded
    or a movie simulated, pull in none of jax, flax, optax, picasso_tpu,
    pandas or sklearn."""
    use = {"nanotron": "m.init_params([4, 3, 2]); m.Adam([], 1e-3)",
           "average3": "m.rotate_axis('x', 1.0, 2.0, 3.0, 0.5, 130)",
           "simulate": "m.simulate_movie(2, 16, 4, seed=1)"}[module]
    code = (
        f"import sys, picasso_torch.{module} as m\n{use}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'jaxlib', 'flax', 'optax', 'picasso_tpu', 'pandas', 'sklearn')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", ["design", "design_sequences", "updater",
                                    "server", "server.db", "server.watcher",
                                    "gui", "gui.base", "gui.apps",
                                    "gui.plugins"])
def test_frontend_module_imports_no_jax_pandas_or_sklearn(module):
    """The port's design tools, updater, server query layer and watcher,
    and its GUI apps, each imported alone, pull in none of jax,
    picasso_tpu, bench, pandas or sklearn (nor matplotlib, which the apps
    import in their constructors)."""
    code = (
        f"import sys, picasso_torch.{module}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'jaxlib', 'picasso_tpu', 'bench', 'pandas', 'sklearn', "
        "'matplotlib')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_server_app_is_checked_by_source():
    """server/app.py imports, at any depth, nothing of jax, picasso_tpu,
    bench, pandas or sklearn, and its imports of the port name
    picasso_torch (its ImportError without streamlit:
    tests/test_torch_frontends.py)."""
    path = os.path.join(ROOT, "picasso_torch", "server", "app.py")
    tree = ast.parse(open(path).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module)
    top = {n.split(".")[0] for n in names}
    assert not top & {"jax", "jaxlib", "picasso_tpu", "bench", "pandas",
                      "sklearn"}, names
    assert {"streamlit", "picasso_torch"} <= top


def test_import_touches_no_cuda():
    code = (
        "import torch, picasso_torch, picasso_torch.ops.fused\n"
        "import picasso_torch.parallel, picasso_torch.parallel.dryrun\n"
        "from picasso_torch.parallel import mesh\n"
        "mesh.Mesh(['cpu'] * 4)\n"
        "assert not torch.cuda.is_initialized()\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_ROOT", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not any((tmp_path / "build").rglob(_build.LIB_NAME))


def test_library_builds_once_under_threads(monkeypatch, tmp_path):
    """The mesh's shard workers may reach the kernel library first at the
    same moment: one builds and loads it while the others wait, and all
    get the same library. Without nvcc every thread gets the build's
    error and nothing is cached."""
    import threading
    import time
    import types

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_ROOT", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    _build._load.cache_clear()
    errors, libs = [], []

    def call():
        try:
            libs.append(_build.library())
        except RuntimeError as e:
            errors.append(str(e))

    def run_threads(n=8):
        threads = [threading.Thread(target=call) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    run_threads()
    assert len(errors) == 8 and not libs
    assert all("nvcc not found" in e for e in errors)
    builds = []

    def fake_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)  # the others arrive while this one builds
        return tmp_path / _build.LIB_NAME, 1.0

    class FakeLib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    try:
        run_threads()
        assert len(builds) == 1 and len(libs) == 8
        assert all(lib is libs[0] for lib in libs)
    finally:
        _build._load.cache_clear()


def test_launch_counts_are_exact_under_threads():
    """count_launch adds under a lock, and a thread's tally counts only
    its own launches."""
    import threading

    def kernel():
        pass

    kernel.launches = 0
    tallies = []

    def work():
        with _build.tally() as counts:
            for _ in range(20000):
                _build.count_launch(kernel)
        tallies.append(counts)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert kernel.launches == 8 * 20000
    key = f"{__name__}.kernel"
    assert [t[key] for t in tallies] == [20000] * 8
    with _build.tally() as outer:
        _build.count_launch(kernel, 2)
        with _build.tally() as inner:
            _build.count_launch(kernel)
    assert inner == {key: 1} and outer == {key: 3}


def test_sources_hash_and_cover_every_entry():
    names = [p.name for p in _build.sources()]
    assert {"mle_fit.cu", "identify.cu", "lq_fit.cu", "winfit_mle.cu",
            "winfit_mle_f32.cu", "winfit_lq_queue.cu",
            "winfit_lq_queue_f32.cu", "winfit_lq_queue.cuh", "fit_common.cuh",
            "fit_mle.cuh", "fit_lq.cuh", "winfit_mle_queue.cu",
            "winfit_mle_queue_f32.cu", "winfit_mle_queue.cuh",
            "link_walk.cu", "mle_queue.cuh", "lq_queue.cuh",
            "roi_lq_queue.cu", "roi_mle_fit.cu"} <= set(names)
    assert {"picasso_roi_lq_queue", "picasso_roi_lq_queue_info",
            "picasso_roi_mle_fit",
            "picasso_roi_mle_fit_info"} <= set(_build.SIGNATURES)
    text = "".join(p.read_text() for p in _build.sources())
    for entry in _build.SIGNATURES:
        assert f'extern "C" int {entry}(' in text
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert len(_build.source_hash()) == 16


def test_lq_fit_keeps_only_its_one_pass():
    """K6 is one launch of the LM work queue on the card, so lq_fit.cu
    keeps only K3's one pass: no START/RESUME mode and no carry in its C
    entry (spots, n, box, ftol, k, n_valid, theta, stream) or in the fit
    body it instantiates."""
    assert len(_build.SIGNATURES["picasso_lq_fit"]) == 8
    for name in ("lq_fit.cu", "fit_lq.cuh"):
        text = (_build.CSRC / name).read_text()
        assert "kResume" not in text and "kStart" not in text, name


@pytest.mark.parametrize("wrapper", ["fit_t", "fit_one_pass_t",
                                     "fit_boundary_t",
                                     "fit_multiround_t",
                                     "identify", "lq_fit_t",
                                     "lq_fit_boundary_t", "lq_fit_queue_t",
                                     "winfit_fit_mle_t",
                                     "winfit_fit_mle_boundary_t",
                                     "winfit_fit_mle_queue_t",
                                     "winfit_fit_lq_queue_t",
                                     "identify_in_image", "link_walk",
                                     "cluster_sweep"])
def test_wrappers_do_not_fall_back_off_the_cpu(wrapper):
    """A tensor on any device but the CPU goes to the kernel or raises;
    the plain version is never taken for it."""
    if wrapper.startswith("winfit_"):
        frames = torch.empty((2, 32, 32), dtype=torch.uint16, device="meta")
        hit = torch.full((4,), 10, device="meta")
        fn = getattr(winfit_cuda, wrapper[len("winfit_"):])
        kw = dict(box=7, max_it=10) | ({} if "lq" in wrapper else
                                       dict(eps=1e-3))
        call = lambda: fn(frames, hit, hit, hit, 0.0, 1.0, **kw)  # noqa: E731
    elif wrapper == "identify":
        frames = torch.empty((2, 32, 32), dtype=torch.uint16, device="meta")
        call = lambda: identify_cuda.identify_tiles(frames, 100.0, 7)  # noqa: E731
    elif wrapper == "link_walk":
        off = torch.zeros(3, dtype=torch.int64, device="meta")
        call = lambda: link.walk(off, off)  # noqa: E731
    elif wrapper == "cluster_sweep":
        from picasso_torch.ops import cluster

        off = torch.zeros(3, dtype=torch.int64, device="meta")
        call = lambda: cluster.sweep(off, off, off, off, 3)  # noqa: E731
    elif wrapper == "identify_in_image":
        image = torch.empty((32, 32), device="meta")
        call = lambda: localize.identify_in_image(  # noqa: E731
            image, 100.0, 7)
    elif wrapper.startswith("lq_"):
        spots = torch.empty((7, 7, 16), device="meta")
        fn = getattr(lq_cuda, wrapper[3:])
        call = lambda: fn(spots, 10)  # noqa: E731
    else:
        spots = torch.empty((7, 7, 16), device="meta")
        fn = getattr(mle_cuda, wrapper)
        call = lambda: fn(spots, 1e-3, 10)  # noqa: E731
    with pytest.raises(ValueError, match="meta"):
        call()


def _counts():
    return (mle_cuda.fit_t.launches, mle_cuda.fit_one_pass_t.launches,
            mle_cuda.fit_boundary_t.launches,
            mle_cuda.fit_multiround_t.launches,
            lq_cuda.fit_t.launches, lq_cuda.fit_boundary_t.launches,
            lq_cuda.fit_queue_t.launches,
            identify_cuda.identify_tiles.launches,
            winfit_cuda.fit_mle_t.launches,
            winfit_cuda.fit_mle_boundary_t.launches,
            winfit_cuda.fit_lq_queue_t.launches,
            winfit_cuda.fit_mle_queue_t.launches, link.walk.launches)


def test_cpu_tensors_take_the_plain_versions_without_counting():
    before = _counts()
    spots = torch.rand((7, 7, 8)) * 100 + 10
    mle_cuda.fit_boundary_t(spots, 1e-3, 20)
    mle_cuda.fit_t(spots, 1e-3, 20, "sigma")
    mle_cuda.fit_one_pass_t(spots, 1e-3, 20)
    mle_cuda.fit_multiround_t(spots, 1e-3, 20)
    lq_cuda.fit_t(spots, 20)
    lq_cuda.fit_boundary_t(spots, 20)
    lq_cuda.fit_queue_t(spots, 20)
    identify_cuda.identify_tiles(torch.zeros((1, 16, 16)), 100.0, 7)
    frames = (torch.rand((2, 16, 16)) * 100).to(torch.uint16)
    hit = torch.tensor([1, 8])
    winfit_cuda.fit_mle_t(frames, hit, hit, hit, 0.0, 1.0, box=7, eps=1e-3,
                          max_it=20)
    winfit_cuda.fit_mle_boundary_t(frames, hit, hit, hit, 0.0, 1.0, box=7,
                                   eps=1e-3, max_it=20)
    winfit_cuda.fit_mle_queue_t(frames, hit, hit, hit, 0.0, 1.0, box=7,
                                eps=1e-3, max_it=20)
    winfit_cuda.fit_lq_queue_t(frames, hit, hit, hit, 0.0, 1.0, box=7,
                               max_it=20)
    ids = link.walk(torch.tensor([0, 1, 1]), torch.tensor([1]))
    assert ids.tolist() == [0, 0]
    assert before == _counts()


@pytest.mark.parametrize("route", ["phases", "k1"])
def test_fit2d_routes_on_the_cpu_match_jax(monkeypatch, route):
    """gaussmle.gaussmle (both methods) and lq.fit_spots_batched on the
    CPU equal picasso_tpu's fits within compare_fits / compare_lq_fits
    whichever route constant (mle_cuda.ROI_FITS, lq_cuda.ROI_FIT) is
    set: a CPU tensor takes the plain fit on every route, uncounted."""
    from picasso_torch import gaussmle
    from picasso_torch.ops import lq
    from picasso_tpu import gaussmle as jmle
    from picasso_tpu.ops import lq as jlq
    from torch_parity import compare_fits, compare_lq_fits

    mle_fit = {"phases": mle_cuda.fit_boundary_t, "k1": mle_cuda.fit_t}[route]
    monkeypatch.setattr(mle_cuda, "ROI_FITS",
                        {"sigmaxy": mle_fit, "sigma": mle_fit})
    monkeypatch.setattr(lq_cuda, "ROI_FIT", lq_cuda.fit_t if route ==
                        "phases" else lq_cuda.fit_queue_t)
    spots = torch_data.make_spots(300, 7, seed=11)
    before = _counts()
    for method in ("sigmaxy", "sigma"):
        got = gaussmle.gaussmle(spots, 1e-3, 100, method, device="cpu")
        want = jmle.gaussmle(spots, 1e-3, 100, method)
        compare_fits([np.asarray(a).T if np.ndim(a) == 2 else np.asarray(a)
                      for a in want],
                     [a.T if a.ndim == 2 else a for a in got], 100)
    got = lq.fit_spots_batched(spots, 30, device="cpu")
    want = np.asarray(jlq.fit_spots_batched(spots, 30))
    compare_lq_fits(want.T, got.T, spots.transpose(1, 2, 0))
    assert before == _counts()


@pytest.mark.parametrize("seed", [0, 5])
def test_data_copies_equal_bench(seed):
    """tests/torch_data.py makes the same arrays as the JAX package's
    bench.py from the same seeds."""
    for box in (5, 7):
        np.testing.assert_array_equal(torch_data.make_spots(64, box, seed),
                                      bench.make_spots(64, box, seed))
    args = (6, 48, 20, 0.5)
    np.testing.assert_array_equal(
        torch_data.make_bench_movie(*args, np.random.default_rng(seed)),
        bench.make_bench_movie(*args, np.random.default_rng(seed)))


def test_post_localize_entry_points_need_the_card_or_cpu(tmp_path):
    """Without device="cpu" and without a card the drift corrections,
    the renders, linking, the statistics and their verbs raise; none
    falls back to the CPU."""
    from picasso_torch import __main__ as cli
    from picasso_torch import aim, imageprocess, io, postprocess, render

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    locs = np.zeros(4, [("frame", np.uint32), ("x", np.float32),
                        ("y", np.float32), ("lpx", np.float32),
                        ("lpy", np.float32), ("len", np.int64),
                        ("group", np.int32), ("cluster", np.int32),
                        ("photons", np.float32)])
    locs["frame"] = np.arange(4)
    locs["x"] = locs["y"] = 3.0
    locs["lpx"] = locs["lpy"] = 0.1
    info = [{"Frames": 4, "Width": 8, "Height": 8, "Pixelsize": 130}]
    path = str(tmp_path / "x_locs.hdf5")
    io.save_locs(path, locs, info)
    calls = [
        lambda: render.render(locs, info, blur_method="convolve"),
        lambda: render.render_hist(locs, 1.0, 0, 0, 8, 8),
        lambda: aim.aim(locs, info, segmentation=2),
        lambda: aim.intersection_max(locs["x"], locs["y"], locs["x"],
                                     locs["y"], locs["frame"] + 1,
                                     np.array([0, 2, 4]), 0.2, 0.5, 8),
        lambda: imageprocess.find_fiducials(locs, info),
        lambda: postprocess.undrift_from_fiducials(locs, info),
        lambda: localize.identify_in_image(np.zeros((16, 16)), 1.0, 7),
        lambda: postprocess.link(locs, info),
        lambda: postprocess.link_groups(locs["frame"], locs["x"], locs["y"],
                                        locs["group"], 1.0, 1),
        lambda: postprocess.dark_times(locs),
        lambda: postprocess.compute_dark_times(locs),
        lambda: postprocess.groupprops(locs),
        lambda: postprocess.nena(locs, info),
        lambda: postprocess.frc(locs, info, ((0, 0), (8, 8))),
        lambda: postprocess.compute_local_density(locs, info, 1.0),
        lambda: postprocess.distance_histogram(locs, info, 0.1, 1.0),
        lambda: postprocess.pair_correlation(locs, info, 0.1, 1.0),
        lambda: postprocess.nn_analysis(np.zeros((3, 2)), np.zeros((3, 2)),
                                        1),
        lambda: postprocess.cluster_combine(locs),
        lambda: postprocess.cluster_combine_dist(locs),
    ] + [lambda verb=verb: cli.main([verb, path]) for verb in (
        "undrift", "aim", "undrift_fiducials", "render", "link", "dark",
        "nneighbor", "groupprops", "pc", "cluster_combine",
        "cluster_combine_dist")] + [lambda: cli.main(["density", path, "1"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "x_locs.hdf5", "x_locs.yaml"]
