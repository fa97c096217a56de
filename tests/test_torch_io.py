"""The port's movie readers and raw conversion held against picasso_tpu.io
on the same files: TIFF (classic, BigTIFF, big-endian, strips, f32),
the multi-file TIFF series rules, MetaMorph STK (single and numbered
siblings), Bitplane IMS (both layouts, several channels), the ND2 gate
and its metadata helpers, ``load_movie``'s dispatch, and ``toraw``
(python -m picasso_torch toraw) byte for byte."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

from picasso_tpu import io as jio
from picasso_torch import io as tio
from test_io import _write_ims, _write_stk
from test_nd2_metadata import CONFIG, SIZES, TEXT_INFO
from torch_data import write_tiff

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_movie(t_movie, j_movie, expect=None):
    """Frames by int, negative int, slice and list, dtype and shape."""
    n = len(j_movie)
    assert len(t_movie) == n and t_movie.shape == j_movie.shape
    assert t_movie.dtype == j_movie.dtype
    full = j_movie[0:n]
    if expect is not None:
        np.testing.assert_array_equal(full, expect)
    np.testing.assert_array_equal(t_movie[0:n], full)
    assert t_movie[0:n].dtype.byteorder in "=|<"
    np.testing.assert_array_equal(t_movie[n - 1], full[-1])
    np.testing.assert_array_equal(t_movie[-1], full[-1])
    np.testing.assert_array_equal(t_movie[[n - 1, 0]], full[[n - 1, 0]])
    np.testing.assert_array_equal(np.stack(list(t_movie)), full)


@pytest.mark.parametrize("dtype", [np.uint16, np.float32, np.int16, np.uint8])
@pytest.mark.parametrize("layout", [
    dict(), dict(bigtiff=True), dict(byteorder=">"),
    dict(bigtiff=True, byteorder=">", rows_per_strip=3),
    dict(rows_per_strip=4),
])
def test_tiff_matches_jax(tmp_path, dtype, layout):
    rng = np.random.default_rng(0)
    frames = (rng.random((4, 10, 7)) * 250).astype(dtype)
    path = str(tmp_path / "movie.tif")
    write_tiff(path, frames, description="acquisition", **layout)
    t_movie, t_info = tio.load_movie(path)
    j_movie, j_info = jio.load_movie(path)
    assert t_info == [dict(j_info[0], File=t_info[0]["File"])]
    assert t_info[0]["Data Type"] == np.dtype(dtype).name
    _same_movie(t_movie, j_movie, frames)
    assert t_movie.maps[0].first_ifd_description == "acquisition"
    t_movie.close()


def test_truncated_tiff_raises(tmp_path):
    path = str(tmp_path / "cut.tif")
    write_tiff(path, np.ones((2, 8, 8), np.uint16))
    data = open(path, "rb").read()
    # the pixel data of frame 1 ends where the IFDs begin: shift its
    # strip past the end of the file
    movie = tio.TiffMap(path)
    movie._frame_offsets[1] = [(len(data) - 16, 128)]
    with pytest.raises(ValueError, match="truncated"):
        movie.get_frame(1)
    movie.close()
    with open(path, "wb") as f:
        f.write(b"XX" + data[2:])
    with pytest.raises(ValueError, match="not a TIFF"):
        tio.TiffMap(path)


def _parts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 999, (2, 8, 8)).astype(np.uint16)
            for _ in range(n)]


@pytest.mark.parametrize("case", ["ome", "suffixed", "solo", "ndtiff"])
def test_tiff_series_rules_match_jax(tmp_path, case):
    """MicroManager .ome.tif parts in numeric order (_10 after _2), a
    suffixed part joining only the later ones, an unrelated numbered
    file left out, NDTiffStack's base.tif + base_1.tif."""
    if case == "ome":
        parts = _parts(12, 0)
        names = ["movie.ome.tif"] + [f"movie_{i}.ome.tif"
                                     for i in range(1, 12)]
        opened, expect = names[0], parts
    elif case == "suffixed":
        parts = _parts(4, 1)
        names = [f"series_{i}.tif" for i in range(4)]
        opened, expect = names[2], parts[2:]
    elif case == "solo":
        parts = _parts(2, 2)
        names = ["solo.tif", "other_1.tif"]
        opened, expect = names[0], parts[:1]
    else:
        parts = _parts(3, 3)
        names = ["run_NDTiffStack.tif", "run_NDTiffStack_1.tif",
                 "run_NDTiffStack_2.tif"]
        opened, expect = names[0], parts
    for name, part in zip(names, parts):
        write_tiff(str(tmp_path / name), part)
    t_movie, t_info = tio.load_tif(str(tmp_path / opened))
    j_movie, j_info = jio.load_tif(str(tmp_path / opened))
    assert t_info == j_info
    _same_movie(t_movie, j_movie, np.concatenate(expect))


def test_stk_single_and_multi_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    mov = rng.integers(0, 4000, (5, 16, 24)).astype(np.uint16)
    p1 = str(tmp_path / "stack_1.stk")
    _write_stk(p1, mov)
    t_movie, t_info = tio.load_movie(p1)
    j_movie, j_info = jio.load_movie(p1)
    assert type(t_movie).__name__ == "STKMovie"
    assert t_info == j_info
    _same_movie(t_movie, j_movie, mov)
    _write_stk(str(tmp_path / "stack_2.stk"), mov + 1)
    _write_stk(str(tmp_path / "stack_0.stk"), mov + 2)  # before the first
    t_movie, t_info = tio.load_stk(p1)
    j_movie, j_info = jio.load_stk(p1)
    assert type(t_movie).__name__ == "STKMultiMovie"
    assert t_info == j_info and t_info[0]["Frames"] == 10
    _same_movie(t_movie, j_movie, np.concatenate([mov, mov + 1]))


@pytest.mark.parametrize("layout", ["timepoints", "stack"])
def test_ims_layouts_match_jax(tmp_path, layout):
    rng = np.random.default_rng(4)
    mov = rng.integers(0, 3000, (6, 12, 10)).astype(np.uint16)
    path = str(tmp_path / "movie.ims")
    _write_ims(path, mov, layout=layout, channels=2)
    t_movie, t_info = tio.load_movie(path)
    j_movie, j_info = jio.load_movie(path)
    assert t_info == j_info and t_movie.pixelsize == j_movie.pixelsize
    _same_movie(t_movie, j_movie, mov)
    t_movie, _ = tio.load_ims(path, prompt_info=lambda ch: ch[1])
    np.testing.assert_array_equal(t_movie[2], mov[2] + 1000)
    t_all, t_infos = tio.load_ims_all(path)
    j_all, j_infos = jio.load_ims_all(path)
    assert t_infos == j_infos
    for t, j in zip(t_all, j_all):
        _same_movie(t, j)


@pytest.mark.parametrize("stacked", [False, True])
def test_ims_from_the_jax_writer(tmp_path, stacked):
    """Files of picasso_tpu.io.write_ims (padded blocks, gzip) read as
    JAX reads them."""
    mov = np.random.default_rng(5).integers(0, 999, (5, 16, 12),
                                            dtype=np.uint16)
    path = str(tmp_path / "w.ims")
    jio.write_ims(path, mov, pixelsize=108.0, stacked=stacked)
    t_movie, t_info = tio.load_ims(path)
    j_movie, j_info = jio.load_ims(path)
    assert t_info == j_info
    _same_movie(t_movie, j_movie, mov)
    t_movie.close()


def test_ims_bad_layout_and_channel(tmp_path):
    import h5py

    path = str(tmp_path / "bad.ims")
    with h5py.File(path, "w") as f:
        f.create_group("DataSet")
    with pytest.raises(ValueError, match="unrecognized IMS layout"):
        tio.IMSMovie(path)
    _write_ims(path, np.zeros((2, 4, 4), np.uint16))
    with pytest.raises(ValueError, match="channels"):
        tio.IMSMovie(path, channel="Channel 7")


def test_nd2_needs_the_optional_package(tmp_path):
    path = str(tmp_path / "x.nd2")
    open(path, "wb").close()
    try:
        import nd2  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="optional 'nd2' package"):
            tio.load_movie(path)
    else:
        pytest.skip("nd2 is installed")


def test_nd2_metadata_helpers_match_jax():
    text = TEXT_INFO["description"]
    assert tio.nikontext_to_dict(text) == jio.nikontext_to_dict(text)
    long_line = "A\r\nk: a: b: c\r\nB: 1"
    assert tio.nikontext_to_dict(long_line) == jio.nikontext_to_dict(
        long_line)
    for text_info in (TEXT_INFO, {}, {"description": "x: y"}):
        t = tio.nd2_meta_from_text_info("f.nd2", SIZES, "uint16", text_info)
        assert t == jio.nd2_meta_from_text_info("f.nd2", SIZES, "uint16",
                                                text_info)
    meta = tio.nd2_meta_from_text_info("f.nd2", SIZES, "uint16", TEXT_INFO)
    assert tio.nd2_camera_parameters(meta, CONFIG) == (
        jio.nd2_camera_parameters(meta, CONFIG))
    bare = {k: v for k, v in meta.items() if k != "Picasso Metadata"}
    assert tio.nd2_camera_parameters(bare, CONFIG) == (
        jio.nd2_camera_parameters(bare, CONFIG))
    for bad in ({}, {"Cameras": {}}):
        with pytest.raises(KeyError):
            tio.nd2_camera_parameters(meta, bad)


def test_load_movie_dispatch(tmp_path):
    with pytest.raises(ValueError, match="Unsupported movie format: .avi"):
        tio.load_movie(str(tmp_path / "x.avi"))
    mov = np.arange(2 * 4 * 4, dtype=np.uint16).reshape(2, 4, 4)
    info = [{"Byte Order": ">", "Data Type": "uint16", "Frames": 2,
             "Height": 4, "Width": 4}]
    jio.save_raw(str(tmp_path / "x.raw"), mov.astype(">u2"), info)
    t_movie, t_info = tio.load_movie(str(tmp_path / "x.raw"))
    j_movie, j_info = jio.load_movie(str(tmp_path / "x.raw"))
    assert t_info == j_info
    np.testing.assert_array_equal(t_movie, j_movie)
    np.testing.assert_array_equal(t_movie, mov)


def test_save_raw_matches_jax(tmp_path):
    mov = np.random.default_rng(6).integers(0, 999, (3, 5, 6),
                                            dtype=np.uint16)
    info = [{"Byte Order": "<", "Data Type": "uint16", "Frames": 3,
             "Height": 5, "Width": 6}]
    tio.save_raw(str(tmp_path / "t.raw"), mov, info)
    jio.save_raw(str(tmp_path / "j.raw"), mov, info)
    for ext in (".raw", ".yaml"):
        assert (tmp_path / f"t{ext}").read_bytes() == (
            tmp_path / f"j{ext}").read_bytes()


@pytest.mark.parametrize("by", ["api", "cli"])
def test_toraw_matches_jax(tmp_path, by):
    """A two-part series c.tif + c_1.tif (joined), a MicroManager pair
    a.ome.tif + a_1.ome.tif (each its own group: the suffix rule wants a
    single extension after the number, in both packages) and a single
    big-endian TIFF, converted by both packages in turn in one folder:
    the same raw bytes and YAML."""
    rng = np.random.default_rng(7)
    parts = [rng.integers(0, 999, (3, 6, 5)).astype(np.uint16)
             for _ in range(2)]
    for name, part in (("a.ome.tif", parts[0]), ("a_1.ome.tif", parts[1]),
                       ("c.tif", parts[0]), ("c_1.tif", parts[1])):
        write_tiff(str(tmp_path / name), part)
    write_tiff(str(tmp_path / "b.tif"), parts[0][:2], byteorder=">")
    pattern = str(tmp_path / "*.tif")
    names = sorted(os.listdir(tmp_path))
    assert tio.get_movie_groups(names) == jio.get_movie_groups(names)
    jio.to_raw(pattern, verbose=False)
    outs = sorted(set(os.listdir(tmp_path)) - set(names))
    assert outs == ["a.ome.ome.raw", "a.ome.ome.yaml", "a_1.ome.ome.raw",
                    "a_1.ome.ome.yaml", "b.ome.raw", "b.ome.yaml",
                    "c.ome.raw", "c.ome.yaml"]
    ref = {name: (tmp_path / name).read_bytes() for name in outs}
    for name in outs:
        os.remove(tmp_path / name)
    if by == "api":
        tio.to_raw(pattern, verbose=False)
    else:
        env = dict(os.environ, PYTHONPATH=ROOT)
        proc = subprocess.run(
            [sys.executable, "-m", "picasso_torch", "toraw", pattern],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=120)
        assert proc.returncode == 0, proc.stderr
    for name in outs:
        assert (tmp_path / name).read_bytes() == ref[name], name
    movie, info = tio.load_movie(str(tmp_path / "c.ome.raw"))
    np.testing.assert_array_equal(movie, np.concatenate(parts))
    assert info[0]["Frames"] == 6
