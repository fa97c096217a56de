"""The rest of io and the readers' and filters' helpers of lib of the port
held against picasso_tpu on the CPU: the exporters (ThunderSTORM,
ImageJ, NIS Elements, Chimera, ViSP) byte for byte on f32 and f64 locs
with and without z, import_ts, the Imaris writers, identifications,
spots, filters, calibrations, masks, user settings and the camera
config; AutoDict, append_to_rec, remove_from_rec, the bins and 2D
histograms, the filter steps, locs_glob_map, is_path_available and
unpack_calibration; and the verbs csv2hdf, hdf2csv, hdf2ts, hdf2imagej,
hdf2nis, hdf2chimera, hdf2visp and toims against the JAX CLI.

Everything here is host code and compares equal: text files byte for
byte (pandas' to_csv writes each column's shortest repr in its dtype,
which lib.csv_strings writes too), tables field by field with their
dtypes, HDF5 files by their groups, datasets and attributes (the Imaris
files but the Description, which names the writing package).
"""

from __future__ import annotations

import os

import h5py
import numpy as np
import pandas as pd
import pytest
import yaml

from picasso_tpu import __main__ as jmain
from picasso_tpu import io as jio
from picasso_tpu import lib as jlib
from picasso_torch import __main__ as tmain
from picasso_torch import io as tio
from picasso_torch import lib as tlib

EXPORTS = ("export_ts", "export_thunderstorm", "export_txt_imagej",
           "export_txt_nis", "export_xyz_chimera", "export_3d_visp")


def _locs(n=400, seed=0, dtype=np.float32, z=True):
    """Locs as localize_3D writes them (z in nm), every float field in
    ``dtype``; values spread over decades so that the writers' number
    formats are exercised."""
    rng = np.random.default_rng(seed)
    names = ["x", "y"] + (["z"] if z else []) + [
        "photons", "sx", "sy", "bg", "lpx", "lpy"]
    locs = np.zeros(n, [("frame", np.uint32)] + [(c, dtype) for c in names]
                    + [("group", np.int32)])
    locs["frame"] = np.sort(rng.integers(0, 3000, n))
    locs["x"], locs["y"] = rng.uniform(0, 255, (2, n))
    if z:
        locs["z"] = rng.uniform(-400, 400, n)
    locs["photons"] = np.exp(rng.uniform(3, 10, n))
    locs["bg"] = rng.uniform(0, 40, n)
    locs["bg"][:8] = [0.5, 1.5, 2.5, 3.5, -0.5, 10.5, 11.5, 12.5]
    locs["sx"], locs["sy"] = rng.uniform(0.7, 1.8, (2, n))
    locs["lpx"], locs["lpy"] = 10.0 ** rng.uniform(-4, -0.5, (2, n))
    locs["group"] = rng.integers(0, 9, n)
    return locs


def _info(px=130):
    return [{"Frames": 3000, "Height": 256, "Width": 256, "Pixelsize": px}]


def _df(locs):
    return pd.DataFrame.from_records(locs)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_table(got: np.ndarray, ref: pd.DataFrame):
    assert got.dtype.names == tuple(ref.columns)
    for n in got.dtype.names:
        assert got.dtype[n] == ref[n].dtype, n
        np.testing.assert_array_equal(got[n], ref[n].to_numpy(), err_msg=n)


# ---------------------------------------------------------------------------
# the exporters and import_ts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", EXPORTS)
@pytest.mark.parametrize("dtype,z,px", [(np.float32, True, 130),
                                        (np.float32, False, 108.5),
                                        (np.float64, True, 108.5),
                                        (np.float64, False, 130)])
def test_exporters_write_jaxs_bytes(tmp_path, name, dtype, z, px):
    locs, info = _locs(dtype=dtype, z=z), _info(px)
    t, j = tmp_path / "t.txt", tmp_path / "j.txt"
    if not z and name in ("export_xyz_chimera", "export_3d_visp"):
        for mod, path, df in ((tio, t, locs), (jio, j, _df(locs))):
            with pytest.warns(UserWarning, match="No z coordinate"):
                getattr(mod, name)(str(path), df, info)
        assert not t.exists() and not j.exists()
        return
    getattr(tio, name)(str(t), locs, info)
    getattr(jio, name)(str(j), _df(locs), info)
    assert _bytes(t) == _bytes(j)
    assert len(_bytes(t)) > 100 * len(locs) // 10


def test_import_ts_matches_jax_and_round_trips(tmp_path):
    locs, info = _locs(), _info()
    path = str(tmp_path / "a_ts.csv")
    jio.export_ts(path, _df(locs), info)
    got, got_info = tio.import_ts(path, pixelsize=130)
    ref, ref_info = jio.import_ts(path, pixelsize=130)
    _assert_table(got, ref)
    assert got_info == ref_info
    # back: the unscaled columns exactly, the columns written in nm within
    # 2 f32 ulps (x * 130 rounded in f32, / 130 in f64, then to f32)
    for c in ("frame", "photons", "bg"):
        np.testing.assert_array_equal(got[c], locs[c])
    for c in ("x", "y", "sx", "sy"):
        np.testing.assert_array_max_ulp(got[c], locs[c], maxulp=2)
    np.testing.assert_array_max_ulp(got["lpx"], (locs["lpx"] + locs["lpy"])
                                    / 2, maxulp=2)


def test_import_ts_of_a_thunderstorm_file_matches_jax(tmp_path):
    """A ThunderSTORM file as that program writes it (quoted header, one
    sigma, empty cells that pandas reads as NaN), and an empty one."""
    path = tmp_path / "ts.csv"
    path.write_text(
        '"id","frame","x [nm]","y [nm]","sigma [nm]","intensity [photon]",'
        '"offset [photon]"\n'
        "1,1,1304.2,2210.55,140.1,1500.0,12.5\n"
        "2,1,2304.25,210.5,,2500.75,\n"
        "3,4,304.0,9210.125,160.3,900.0,11.0\n")
    for p, px in ((path, 160.0), (path, 130)):
        got, got_info = tio.import_ts(str(p), pixelsize=px)
        ref, ref_info = jio.import_ts(str(p), pixelsize=px)
        _assert_table(got, ref)
        assert got_info == ref_info
    empty = tmp_path / "empty.csv"
    empty.write_text("id,frame,x [nm],y [nm]\n")
    got, got_info = tio.import_ts(str(empty))
    ref, ref_info = jio.import_ts(str(empty))
    _assert_table(got, ref)
    assert got_info == ref_info and len(got) == 0


# ---------------------------------------------------------------------------
# Imaris
# ---------------------------------------------------------------------------


def _h5_tree(path):
    """Every group's and dataset's attributes and every dataset's data,
    by name (the Imaris Description left out)."""
    out = {}

    def visit(name, obj):
        attrs = {k: bytes(np.asarray(v)) for k, v in obj.attrs.items()
                 if k != "Description"}
        out[name] = (attrs, obj[()] if isinstance(obj, h5py.Dataset)
                     else None)

    with h5py.File(path, "r") as f:
        visit("/", f)
        f.visititems(visit)
    return out


def _assert_same_h5(a, b):
    ta, tb = _h5_tree(a), _h5_tree(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k][0] == tb[k][0], k
        if ta[k][1] is not None:
            assert ta[k][1].dtype == tb[k][1].dtype
            np.testing.assert_array_equal(ta[k][1], tb[k][1], err_msg=k)


@pytest.mark.parametrize("stacked", [False, True])
def test_write_ims_matches_jax_and_reads_back(tmp_path, stacked):
    movie = np.random.default_rng(1).integers(0, 900, (5, 12, 16),
                                              dtype=np.uint16)
    info = [{"Pixelsize": 108, "Frames": 5}]
    t, j = str(tmp_path / "t.ims"), str(tmp_path / "j.ims")
    tio.write_ims(t, movie, info, stacked=stacked)
    jio.write_ims(j, movie, info, stacked=stacked)
    _assert_same_h5(t, j)
    back, _ = tio.load_ims(t)
    np.testing.assert_array_equal(back[:], movie)
    with pytest.raises(ValueError, match="frames, Y, X"):
        tio.write_ims(t, movie[0])


@pytest.mark.parametrize("z_range", [(0, 0), (-300.0, 250.0)])
def test_numpy_to_imaris_matches_jax(tmp_path, z_range):
    vol = np.random.default_rng(2).random((2, 3, 10, 14)).astype(np.float32)
    info = [{"ExtMin0": 1.5, "ExtMin1": -2.0, "ExtMin2": -1.0,
             "ExtMax2": 3.0}]
    args = (["Red", "Green"], 5.0, ((2.0, 3.0), (4.0, 5.8)), info,
            *z_range, 130)
    t, j = str(tmp_path / "t.ims"), str(tmp_path / "j.ims")
    tio.numpy_to_imaris(vol, t, *args)
    jio.numpy_to_imaris(vol, j, *args)
    _assert_same_h5(t, j)
    tio.numpy_to_imaris(vol[:, 0], t, *args)
    jio.numpy_to_imaris(vol[:, 0], j, *args)
    _assert_same_h5(t, j)


# ---------------------------------------------------------------------------
# the small readers and writers
# ---------------------------------------------------------------------------


def test_identifications_spots_and_filters_match_jax(tmp_path):
    info = _info()
    ids = np.zeros(20, [("frame", np.int32), ("x", np.int32),
                        ("y", np.int32), ("net_gradient", np.float32)])
    ids["x"] = np.arange(20)
    ids["net_gradient"] = np.linspace(1000, 9000, 20)
    path = str(tmp_path / "ids.hdf5")
    tio.save_identifications(path, ids, info)
    got, got_info = tio.load_identifications(path)
    ref, ref_info = jio.load_identifications(path)
    _assert_table(got, ref)
    assert got_info == ref_info == info
    for ext in (".npy", ".tif"):
        spots = np.random.default_rng(3).random((4, 7, 7)).astype(np.float32)
        path = str(tmp_path / f"spots{ext}")
        tio.save_spots(path, spots, info)
        got, got_info = tio.load_spots(path)
        ref, ref_info = jio.load_spots(path)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, spots)
        assert got_info == ref_info
        with pytest.raises(ValueError, match="Unsupported spots"):
            tio.save_spots(str(tmp_path / "s.png"), spots, info)
    locs = _locs(30)
    for key in ("locs", "groups", "clusters"):
        path = str(tmp_path / f"{key}.hdf5")
        tio.save_datasets(path, info, **{key: locs})
        got, got_info = tio.load_filter(path)
        ref, ref_info = jio.load_filter(path)
        _assert_table(got, ref)
        assert got_info == ref_info
    path = str(tmp_path / "other.hdf5")
    tio.save_datasets(path, info, other=locs)
    for mod in (tio, jio):
        with pytest.raises(KeyError, match="No recognized dataset"):
            mod.load_filter(path)
        with pytest.raises(KeyError, match="identifications"):
            mod.load_identifications(path)
    assert tio.generated_by("Render") == jio.generated_by("Render")


def test_calibration_mask_settings_and_config_match_jax(tmp_path,
                                                        monkeypatch):
    calib = {"X Coefficients": [1e-7, 2e-5, 1.2], "Y Coefficients": [
        -1e-7, 3e-5, 1.1], "Step size in nm": 10, "Number of frames": 5,
        "Magnification factor": 0.79}
    path = str(tmp_path / "calib.yaml")
    with open(path, "w") as f:
        yaml.dump(calib, f)
    assert tio.load_calibration(path) == jio.load_calibration(path) == calib
    with open(path, "w") as f:
        yaml.dump({"X Coefficients": [1.0]}, f)
    for mod in (tio, jio):
        with pytest.raises(KeyError, match="Y Coefficients"):
            mod.load_calibration(path)
    mask = np.random.default_rng(4).random((6, 8))
    for by, ok in (("Picasso v0.1.0 SPINNA mask", True), ("Render", False)):
        np.save(tmp_path / "mask.npy", mask)
        tio.save_info(str(tmp_path / "mask.yaml"), [{"Generated by": by}])
        path = str(tmp_path / "mask.npy")
        if ok:
            got, ref = tio.load_mask(path), jio.load_mask(path)
            np.testing.assert_array_equal(got[0], ref[0])
            assert got[1] == ref[1]
        else:
            for mod in (tio, jio):
                with pytest.raises(TypeError, match="SPINNA"):
                    mod.load_mask(path)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert tio.load_user_settings() == {} == jio.load_user_settings()
    settings = tio.load_user_settings()
    settings["Render"]["Colormap"] = "hot"
    settings["Localize"]["Box"] = 7
    assert isinstance(settings["Render"], tlib.AutoDict)
    tio.save_user_settings(settings)
    got, ref = tio.load_user_settings(), jio.load_user_settings()
    assert got == ref == {"Render": {"Colormap": "hot"},
                          "Localize": {"Box": 7}}
    assert isinstance(got["Render"], tlib.AutoDict)
    cfg = tmp_path / "config.yaml"
    monkeypatch.setattr(tio, "_config_path", lambda: str(cfg))
    assert tio.load_config() == {}
    config = {"Cameras": {"Andor": {"Pixelsize": 130, "Quantum Efficiency":
                                    {"Green": 0.75}}}}
    tio.save_config(config)
    assert cfg.read_text() == yaml.dump(config, default_flow_style=False)
    assert tio.load_config() == config


# ---------------------------------------------------------------------------
# lib
# ---------------------------------------------------------------------------


def test_autodict_and_record_helpers_match_jax(capsys):
    a, b = tlib.AutoDict(), jlib.AutoDict()
    for d in (a, b):
        d["x"]["y"]["z"] = 1
        d["w"] = 2
    assert a == b and isinstance(a["x"]["y"], tlib.AutoDict)
    assert tlib.REQUIRED_COLUMNS == jlib.REQUIRED_COLUMNS
    locs = _locs(40, z=False)
    new = np.arange(40, dtype=np.int16)
    for name, data in (("new", new), ("bg", new), ("x", new * 0.5)):
        got = tlib.append_to_rec(locs, data, name)
        _assert_table(got, jlib.append_to_rec(_df(locs), data, name))
    assert "new" not in locs.dtype.names
    rec = locs.view(np.recarray)
    got = tlib.remove_from_rec(rec, "bg")
    out_t = capsys.readouterr().out
    ref = jlib.remove_from_rec(rec, "bg")
    assert capsys.readouterr().out == out_t and "deprecated" in out_t
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    calib = {"X Coefficients": [1e-7, 2e-5, 1.2], "Y Coefficients": [
        -1e-7, 3e-5, 1.1], "Step size in nm": 10, "Number of frames": 21,
        "Magnification factor": 0.79}
    for got, ref in zip(tlib.unpack_calibration(calib, 130),
                        jlib.unpack_calibration(calib, 130)):
        np.testing.assert_array_equal(got, ref)
    assert capsys.readouterr().out.count("unpack_calibration is deprecated") \
        == 2


def test_bins_and_histograms_match_jax():
    rng = np.random.default_rng(5)
    floats = rng.normal(3, 2, 5000).astype(np.float32)
    floats[::17] = np.nan
    cases = [(floats, {}), (floats, {"max_n_bins": 12}),
             (rng.integers(0, 40, 3000), {}),
             (rng.normal(size=3000), {"sample_size": 500}),
             (np.full(50, 2.5), {}), (np.array([]), {}),
             (np.full(10, np.nan), {})]
    for data, kw in cases:
        np.testing.assert_array_equal(tlib.calculate_optimal_bins(data, **kw),
                                      jlib.calculate_optimal_bins(data, **kw))
    x, y = rng.uniform(-1, 11, (2, 4000))
    x[:5] = [10.0, 0.0, np.nan, np.inf, 5.0]
    for fn in ("hist2d", "hist2d_numba"):
        np.testing.assert_array_equal(
            getattr(tlib, fn)(x, y, 0, 10, 0, 10, 20, 15),
            getattr(jlib, fn)(x, y, 0, 10, 0, 10, 20, 15))


def test_filter_steps_match_jax():
    locs = _locs(500, z=False)
    info = _info() + [
        {"Generated by": "Picasso Filter", "photons": [100.0, 5000.0],
         "sx": [0.8, 1.6], "frame": [10, 2900], "ellipticity": [0, 0.3],
         "Removed columns": ["group", "nope"], "note": "x"},
        {"Generated by": "Picasso Render"},
        "not a dict",
        {"Generated by": "picasso-tpu Filter", "Filters": [
            {"Column": "photons", "Min": 200, "Max": 9000},
            {"Column": "lpx", "Min": 0.001, "Max": 0.2},
            {"Column": "missing", "Min": 0, "Max": 1}, {"Min": 0}]},
    ]
    got = tlib.extract_filter_steps(info, locs.dtype.names)
    assert got == jlib.extract_filter_steps(info, _df(locs).columns)
    t_locs, *t_rest = tlib.apply_filter_steps(locs, info)
    j_locs, *j_rest = jlib.apply_filter_steps(_df(locs), info)
    _assert_table(t_locs, j_locs)
    assert t_rest == j_rest and 0 < len(t_locs) < len(locs)


def test_locs_glob_map_and_path_checks_match_jax(tmp_path):
    info = _info()
    for i in range(3):
        tio.save_locs(str(tmp_path / f"m{i}_locs.hdf5"), _locs(50, i, z=False),
                      info)

    def tfn(locs, info, path, scale, shift=0.0):
        locs = locs.copy()
        locs["x"] = locs["x"] * scale + shift
        return locs, info + [{"Generated by": os.path.basename(path)}]

    def jfn(locs, info, path, scale, shift=0.0):
        locs = locs.copy()
        locs["x"] = locs["x"] * scale + shift
        return locs, info + [{"Generated by": os.path.basename(path)}]

    pattern = str(tmp_path / "m*_locs.hdf5")
    got = tlib.locs_glob_map(tfn, pattern, args=[0.5], kwargs={"shift": 1.0},
                             extension="tmap")
    written = {p: tio.load_locs(str(tmp_path / p)) for p in sorted(
        os.listdir(tmp_path)) if p.endswith("_tmap.hdf5")}
    ref = jlib.locs_glob_map(jfn, pattern, args=[0.5], kwargs={"shift": 1.0},
                             extension="tmap")
    assert len(got) == len(ref) == len(written) == 3
    for (gl, gi), (rl, ri) in zip(got, ref):
        _assert_table(gl, rl)
        assert gi == ri
    for p, (locs, info_) in written.items():
        rl, ri = jio.load_locs(str(tmp_path / p))
        _assert_table(locs, rl)
        assert info_ == ri
    path = str(tmp_path / "m0_locs.hdf5")
    for kw in ({}, {"check_ext": ".yaml"}, {"check_ext": [".hdf5", ".png"]}):
        assert tlib.is_path_available(path, **kw) == \
            jlib.is_path_available(path, **kw)


# ---------------------------------------------------------------------------
# the verbs
# ---------------------------------------------------------------------------


def _inputs(folder):
    folder.mkdir()
    info = _info()
    jio.save_locs(str(folder / "a_locs.hdf5"), _df(_locs(300)), info)
    jio.export_ts(str(folder / "b_ts.csv"), _df(_locs(200, 1)), info)
    movie = np.random.default_rng(6).integers(0, 2000, (4, 10, 12),
                                              dtype=np.uint16)
    jio.save_raw(str(folder / "movie.raw"), movie, [{
        "Byte Order": "<", "Data Type": "uint16", "Frames": 4, "Height": 10,
        "Width": 12, "Pixelsize": 117}])
    return folder


_VERBS = {
    "csv2hdf": (["csv2hdf", "{d}/b_ts.csv", "-p", "117"], ["b_ts.hdf5"]),
    "hdf2csv": (["hdf2csv", "{d}/a_locs.hdf5"], ["a_locs.csv"]),
    "hdf2ts": (["hdf2ts", "{d}/a_locs.hdf5"], ["a_locs_ts.csv"]),
    "hdf2imagej": (["hdf2imagej", "{d}/a_locs.hdf5"], ["a_locs_ij.txt"]),
    "hdf2nis": (["hdf2nis", "{d}/a_locs.hdf5"], ["a_locs_nis.txt"]),
    "hdf2chimera": (["hdf2chimera", "{d}/a_locs.hdf5"], ["a_locs.xyz"]),
    "hdf2visp": (["hdf2visp", "{d}/*_locs.hdf5"], ["a_locs.3d"]),
    "toims": (["toims", "{d}/movie.raw"], ["movie.ims"]),
    "toims-stacked": (["toims", "{d}/movie.raw", "--stacked"], ["movie.ims"]),
    "no-files": (["hdf2ts", "{d}/none_*.hdf5"], []),
}


@pytest.mark.parametrize("verb", list(_VERBS))
def test_cli_verbs_match_the_jax_cli(tmp_path, verb, capsys):
    """The port's verb and the JAX CLI's: the same messages and files;
    text files byte for byte, HDF5 tables field by field with their YAML,
    Imaris files by content."""
    argv, produced = _VERBS[verb]
    out = {}
    for d, main in (("t", tmain.main), ("j", jmain.main)):
        folder = _inputs(tmp_path / d)
        main([a.format(d=folder) for a in argv])
        out[d] = capsys.readouterr().out.replace(str(folder), "")
    assert out["t"] == out["j"] and (produced or "No files" in out["t"])
    t, j = tmp_path / "t", tmp_path / "j"
    assert sorted(p.name for p in t.iterdir()) == sorted(
        p.name for p in j.iterdir())
    for name in produced:
        if name.endswith(".hdf5"):
            got, ref = tio.load_locs(str(t / name)), jio.load_locs(
                str(j / name))
            _assert_table(got[0], ref[0])
            assert got[1] == ref[1]
        elif name.endswith(".ims"):
            _assert_same_h5(t / name, j / name)
        else:
            assert _bytes(t / name) == _bytes(j / name), name
