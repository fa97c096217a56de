"""The rest of render of the port held against picasso_tpu on the CPU:
rotated views for every blur on both of JAX's routes (ops/render_ops
gaussian_splat_cov and hist3d), the rotation helpers, the 3D and
anisotropic histograms, the public aliases, render_scene with its
colours, contrast and viewport algebra, the split helpers, the render
index (spatial_index) and profiling.

JAX takes its device route from 50,000 locs in view; the tests set both
packages' threshold to 0 to reach it at a small size, as
tests/test_render.py does.

Tolerances, with the spread measured on the CPU (numpy 2, scipy 1.17,
torch 2.13):
- histograms, ``smooth``, ``convolve`` and every 3D histogram equal: the
  rotation is the same f64 matrix product as scipy's Rotation.apply
  (measured: 0 coordinates differ), the counts exact;
- ``gaussian`` and ``gaussian_iso`` within rtol 1e-5 + atol 1e-6 of the
  image, as the unrotated splats (test_torch_render.py): the splat sums
  its windows in another order, on the host route in f64 (measured max
  2.2e-7 of the image max);
- the render index bit for bit; render_scene's uint8 RGB equal where its
  render is exact (histograms), and within one level for the splats.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.spatial.transform import Rotation

from picasso_tpu import profiling as jprof
from picasso_tpu import render as jrender
from picasso_tpu import spatial_index as jindex
from picasso_tpu.ops import render_ops as jops
from picasso_torch import profiling as tprof
from picasso_torch import render as trender
from picasso_torch import spatial_index as tindex
from picasso_torch.ops import render_ops as tops

SIZE = 48
RTOL, ATOL = 1e-5, 1e-6
BLURS = (None, "gaussian", "gaussian_iso", "smooth", "convolve")
ANG = (0.3, 0.5, 0.2)
VIEWPORT = ((5.3, 3.2), (40.1, 45.7))


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["host", "device"])
def route(request, monkeypatch):
    """JAX's host route, or its device route from 0 locs in view."""
    if request.param == "device":
        monkeypatch.setattr(jops, "_DEVICE_MIN_LOCS", 0)
        monkeypatch.setattr(tops, "DEVICE_MIN_LOCS", 0)
    return request.param


def _info(size=SIZE):
    return [{"Frames": 100, "Height": size, "Width": size, "Pixelsize": 130}]


def _locs3d(n=6000, seed=1, dtype=np.float32, fields="z lpz",
            z=3.0, lpz=0.6):
    """Random locs over the field (some outside it) with precisions of
    0.02-0.3 px, and z within +-``z`` and lpz up to ``lpz`` in the units
    the caller wants (camera px by default)."""
    rng = np.random.default_rng(seed)
    fields = fields.split()
    names = ["frame", "x", "y"] + [f for f in ("z",) if f in fields] + [
        "lpx", "lpy"] + [f for f in ("lpz",) if f in fields]
    locs = np.zeros(n, [(c, dtype if c in ("x", "y") else
                         np.uint32 if c == "frame" else np.float32)
                        for c in names])
    locs["frame"] = rng.integers(0, 100, n)
    locs["x"], locs["y"] = rng.uniform(-1, SIZE + 1, (2, n))
    locs["lpx"], locs["lpy"] = rng.uniform(0.02, 0.3, (2, n))
    if "z" in names:
        locs["z"] = rng.uniform(-z, z, n)
    if "lpz" in names:
        locs["lpz"] = rng.uniform(0.05, lpz, n)
    return locs


def _df(locs):
    return pd.DataFrame.from_records(locs)


def _check(blur, img_j, img_t):
    assert img_t.dtype == np.float32 and img_t.shape == img_j.shape
    if blur in (None, "smooth", "convolve"):
        np.testing.assert_array_equal(img_t, img_j)
    else:
        np.testing.assert_allclose(img_t, img_j, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# ops/render_ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_hist3d_matches_jax(route, dtype):
    rng = np.random.default_rng(1)
    n, ny, nx, nz = 5000, 32, 24, 10
    x = rng.uniform(-2, nx + 2, n).astype(dtype)
    y = rng.uniform(-2, ny + 2, n).astype(dtype)
    z = rng.uniform(0, nz - 1, n).astype(dtype)
    got = tops.hist3d(*(torch.from_numpy(v) for v in (x, y, z)), ny, nx,
                      nz).numpy()
    np.testing.assert_array_equal(got, jops.hist3d(x, y, z, ny, nx, nz))
    assert got.sum() > 0


def _covs(rng, n):
    a, b = rng.uniform(0.5, 3, (2, n))
    rho = rng.uniform(-0.9, 0.9, n)
    covs = np.empty((n, 2, 2))
    covs[:, 0, 0] = a**2
    covs[:, 1, 1] = b**2
    covs[:, 0, 1] = covs[:, 1, 0] = rho * a * b
    return covs


def test_gaussian_splat_cov_matches_jax(route):
    """Random covariances, a few of them degenerate (zero, singular,
    negative determinant: nothing rendered) and a few wider than the
    largest bucket (cut there on the device route)."""
    rng = np.random.default_rng(0)
    n, ny, nx = 4000, 96, 80
    x, y = rng.uniform(0, nx, n), rng.uniform(0, ny, n)
    covs = _covs(rng, n)
    covs[:5] = 0
    covs[5:10] = [[1.0, 1.0], [1.0, 1.0]]
    covs[10:15] = [[1.0, 2.0], [2.0, 1.0]]
    covs[15:20] *= 900
    got = tops.gaussian_splat_cov(torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(covs), ny, nx).numpy()
    _check("gaussian", jops.gaussian_splat_cov(x, y, covs, ny, nx), got)
    only = tops.gaussian_splat_cov(torch.from_numpy(x[:15]),
                                   torch.from_numpy(y[:15]),
                                   torch.from_numpy(covs[:15]), ny, nx)
    assert not only.any()


# ---------------------------------------------------------------------------
# rotated views
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("blur", BLURS)
@pytest.mark.parametrize("fields,dtype", [("z lpz", np.float32),
                                          ("z", np.float64), ("", np.float32)])
def test_rotated_render_matches_jax(route, blur, fields, dtype):
    """Every blur of a tilted view on both routes, of 3D locs with and
    without lpz (twice the lateral mean then) and of 2D locs (z 0), x and
    y in f32 or f64."""
    locs = _locs3d(dtype=dtype, fields=fields)
    kw = dict(oversampling=2.5, viewport=VIEWPORT, blur_method=blur,
              min_blur_width=0.02, ang=ANG)
    n_j, img_j = jrender.render(_df(locs), _info(), **kw)
    n_t, img_t = trender.render(locs, _info(), **kw, device="cpu")
    assert n_t == n_j > 3000
    _check(blur, img_j, img_t)


@pytest.mark.parametrize("blur", ["gaussian", "convolve"])
def test_rotation_by_a_rotation_and_by_zero_matches_jax(blur):
    """``ang`` as a scipy Rotation, and the identity: a view turned by
    (0, 0, 0) is the unrotated view's but for the z blur of the
    splats."""
    locs = _locs3d()
    rot = Rotation.from_rotvec([0.2, -0.4, 0.9])
    kw = dict(oversampling=3.0, blur_method=blur, min_blur_width=0.01)
    for ang in (rot, (0.0, 0.0, 0.0)):
        n_j, img_j = jrender.render(_df(locs), _info(), ang=ang, **kw)
        n_t, img_t = trender.render(locs, _info(), ang=ang, **kw,
                                    device="cpu")
        assert n_t == n_j
        _check(blur, img_j, img_t)
    plain = trender.render(locs, _info(), **kw, device="cpu")
    assert plain[0] == n_t
    if blur == "convolve":
        np.testing.assert_array_equal(plain[1], img_t)


def test_rotation_pins_jaxs_z_in_nm(route):
    """JAX rotates x and y (camera px) together with z as the table holds
    it (nm): a tilt of 0.3 rad throws 3D locs with z within +-300 nm
    ~90 px along y, out of a 48 px field, and lpz in nm blurs each splat
    to the largest bucket. The port mirrors that (ROADMAP queue 3)."""
    locs = _locs3d(z=300.0, lpz=40.0)
    kw = dict(oversampling=2.0, blur_method="gaussian", ang=(0.3, 0.0, 0.0))
    n_j, img_j = jrender.render(_df(locs), _info(), **kw)
    n_t, img_t = trender.render(locs, _info(), **kw, device="cpu")
    assert n_t == n_j
    _check("gaussian", img_j, img_t)
    n_flat = trender.render(locs, _info(), oversampling=2.0,
                            device="cpu")[0]
    assert n_t < 0.5 * n_flat
    # the same locs with z and lpz in camera px stay in view
    px = locs.copy()
    px["z"] /= 130
    px["lpz"] /= 130
    assert trender.render(px, _info(), **kw, device="cpu")[0] > 0.85 * n_flat


def test_rotation_helpers_match_jax():
    for ang in ((0.3, 0.5, 0.2), (-1.0, 2.0, 0.1)):
        np.testing.assert_array_equal(
            trender.rotation_matrix(*ang).as_matrix(),
            jrender.rotation_matrix(*ang).as_matrix())
        np.testing.assert_array_equal(trender.to_rotation(ang).as_quat(),
                                      jrender.to_rotation(ang).as_quat())
    rot = Rotation.from_rotvec([0.1, 0.2, 0.3])
    assert trender.to_rotation(rot) is rot
    assert trender.to_rotation(None) is None
    locs = _locs3d(dtype=np.float64)
    args = (2.0, 3.2, 45.7, 5.3, 40.1, ANG)
    for got, ref in zip(trender.locs_rotation(locs, *args, device="cpu"),
                        jrender.locs_rotation(_df(locs), *args)):
        np.testing.assert_array_equal(got, ref)
    for ref in ([0.0, 0.0, 0.0], [0.0, 0.0, 7.0], [3.0, -1.0, 2.0],
                [0.1, 0.2, 0.3]):
        for r in (rot, Rotation.identity(), Rotation.from_rotvec([0, 0, 3])):
            np.testing.assert_array_equal(trender.closest_rotvec(r, ref),
                                          jrender.closest_rotvec(r, ref))
    a = np.random.default_rng(2).normal(size=(3, 3))
    assert trender.determinant_3x3(a) == jrender.determinant_3x3(a)
    np.testing.assert_array_equal(trender.inverse_3x3(a),
                                  jrender.inverse_3x3(a))


@pytest.mark.parametrize("name,args", [
    ("render_gaussian", (0.02,)), ("render_gaussian_iso", (0.02,)),
    ("render_smooth", ()), ("render_convolve", (0.02,))])
def test_public_aliases_match_jax(name, args):
    locs = _locs3d()
    view = (2.0, 5.3, 3.2, 40.1, 45.7)
    for ang in (None, ANG):
        n_j, img_j = getattr(jrender, name)(_df(locs), *view, *args, ang=ang)
        n_t, img_t = getattr(trender, name)(locs, *view, *args, ang=ang,
                                            device="cpu")
        assert n_t == n_j
        _check(name[7:] if name != "render_convolve" else "convolve",
               img_j, img_t)


# ---------------------------------------------------------------------------
# 3D and anisotropic histograms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_render_hist3d_matches_jax(route, dtype):
    locs = _locs3d(dtype=dtype, z=400.0)
    x, y, z = locs["x"], locs["y"], locs["z"]
    view = (5.3, 3.2, 40.1, 45.7, -350.0, 310.0, 130)
    n_j, img_j = jrender.render_hist3d(x, y, z, 2.0, *view)
    n_t, img_t = trender.render_hist3d(x, y, z, 2.0, *view, device="cpu")
    assert n_t == n_j > 1000 and img_t.shape == img_j.shape
    np.testing.assert_array_equal(img_t, img_j)
    n_j, img_j = jrender.render_hist3d_anisotropic(x, y, z, 2.0, 0.7, *view)
    n_t, img_t = trender.render_hist3d_anisotropic(x, y, z, 2.0, 0.7, *view,
                                                   device="cpu")
    assert n_t == n_j and img_t.shape == img_j.shape
    np.testing.assert_array_equal(img_t, img_j)
    n_j, img_j = jrender.render_hist_anisotropic(x, y, 3.0, 1.5,
                                                 *VIEWPORT[0], *VIEWPORT[1])
    n_t, img_t = trender.render_hist_anisotropic(
        x, y, 3.0, 1.5, *VIEWPORT[0], *VIEWPORT[1], device="cpu")
    assert n_t == n_j
    np.testing.assert_array_equal(img_t, img_j)


def test_render_hist_numba_matches_jax():
    rng = np.random.default_rng(4)
    x, y = rng.uniform(-1.2, 1.2, (2, 3000)).astype(np.float32)
    for got, ref in zip(trender.render_hist_numba(x, y, 10, -1.0, 1.0),
                        jrender.render_hist_numba(x, y, 10, -1.0, 1.0)):
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# scene, colours and viewports
# ---------------------------------------------------------------------------


def _channel(seed):
    locs = _locs3d(n=3000, seed=seed, fields="")
    return locs, _info()


@pytest.mark.parametrize("blur", [None, "gaussian"])
@pytest.mark.parametrize("kw", [
    {},
    {"single_channel_colormap": "hot", "invert_colors": True,
     "contrast": (0.0, 2.0), "return_contrast_limits": True},
    {"single_channel_colormap": "lut", "ang": ANG,
     "return_raw_image": True},
])
def test_render_scene_single_channel_matches_jax(blur, kw):
    locs, info = _channel(5)
    kw = dict(kw, blur_method=blur, disp_px_size=40.0,
              viewport=VIEWPORT)
    if kw.get("single_channel_colormap") == "lut":
        kw["single_channel_colormap"] = trender.stops_to_lut(
            [(0, 0, 0, 0), (0.4, 1, 0, 0.5), (1, 1, 1, 1)])
    ref = jrender.render_scene(_df(locs), info, **kw)
    got = trender.render_scene(locs, info, **kw, device="cpu")
    _compare_scene(blur, ref, got)


def _compare_scene(blur, ref, got):
    assert len(got) == len(ref) and got[1] == ref[1]
    assert got[0].dtype == np.uint8 and got[0].shape == ref[0].shape
    if blur is None:
        np.testing.assert_array_equal(got[0], ref[0])
    else:
        assert np.abs(got[0].astype(int) - ref[0]).max() <= 1
    for a, b in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("blur", [None, "gaussian"])
@pytest.mark.parametrize("colors", [None, "rgb", "lut"])
def test_render_scene_multi_channel_matches_jax(blur, colors):
    chans = [_channel(s) for s in (6, 7, 8)]
    locs = [c[0] for c in chans]
    info = [c[1] for c in chans]
    cmap = {None: None, "rgb": [(1, 0, 0), (0, 1, 0), (0.2, 0.2, 1)],
            "lut": [trender.solid_to_lut(c) for c in
                    ((1, 0.5, 0), (0, 1, 1), (1, 0, 1))]}[colors]
    kw = dict(disp_px_size=50.0, blur_method=blur, colors=cmap,
              relative_intensities=[1.0, 0.5, 2.0],
              return_contrast_limits=True, return_raw_image=True)
    ref = jrender.render_scene([_df(c) for c in locs], info, **kw)
    got = trender.render_scene(locs, info, **kw, device="cpu")
    _compare_scene(blur, ref, got)
    cached = trender.render_scene(locs, info, **dict(
        kw, raw_image_cache=got[3]), device="cpu")
    np.testing.assert_array_equal(cached[0], got[0])
    assert cached[1] == 0


def test_colour_and_viewport_helpers_match_jax():
    rng = np.random.default_rng(3)
    img = rng.random((3, 16, 12)).astype(np.float32)
    np.testing.assert_array_equal(
        trender.scale_intensities(img.copy(), [1.0, 0.3, 2.0]),
        jrender.scale_intensities(img.copy(), [1.0, 0.3, 2.0]))
    np.testing.assert_array_equal(trender.to_8bit(img[0] * 3),
                                  jrender.to_8bit(img[0] * 3))
    u8 = trender.to_8bit(img[0])
    lut = trender.stops_to_lut([(0, 0, 0, 0), (0.5, 0.2, 0.9, 0.1),
                                (1, 1, 1, 1)])
    np.testing.assert_array_equal(
        lut, jrender.stops_to_lut([(0, 0, 0, 0), (0.5, 0.2, 0.9, 0.1),
                                   (1, 1, 1, 1)]))
    np.testing.assert_array_equal(trender.solid_to_lut((0.1, 0.5, 1)),
                                  jrender.solid_to_lut((0.1, 0.5, 1)))
    for cmap in ("magma", lut):
        np.testing.assert_array_equal(trender.apply_colormap(u8, cmap),
                                      jrender.apply_colormap(u8, cmap))
    np.testing.assert_array_equal(trender.get_colors_from_colormap(5),
                                  jrender.get_colors_from_colormap(5))
    np.testing.assert_array_equal(trender.GROUP_COLORS, jrender.GROUP_COLORS)
    assert trender.N_GROUP_COLORS == jrender.N_GROUP_COLORS
    locs = np.zeros(50, [("x", np.float32), ("group", np.int32)])
    locs["group"] = rng.integers(0, 20, 50)
    for shuffle in (False, True):
        np.random.seed(9)
        got = trender.get_group_color(locs, shuffle)
        np.random.seed(9)
        np.testing.assert_array_equal(got, jrender.get_group_color(
            _df(locs), shuffle))
    vp = ((1.5, 2.0), (11.5, 32.0))
    for fn, args in (("viewport_height", ()), ("viewport_width", ()),
                     ("viewport_size", ()), ("viewport_center", ()),
                     ("shift_viewport", (1.5, -2.0)),
                     ("zoom_viewport", (0.5,)),
                     ("zoom_viewport", (2.0, (3.0, 4.0))),
                     ("adjust_viewport_to_aspect_ratio", (1.0,)),
                     ("adjust_viewport_to_aspect_ratio", (0.1,))):
        assert getattr(trender, fn)(vp, *args) == getattr(jrender, fn)(
            vp, *args), fn
    for px, w in ((10, 100), (130, 512), (2.5, 4000)):
        assert trender.optimal_scalebar_length(px, w) == \
            jrender.optimal_scalebar_length(px, w)


def test_split_helpers_match_jax():
    rng = np.random.default_rng(11)
    locs = np.zeros(400, [("x", np.float32), ("photons", np.float32),
                          ("group", np.int32)])
    locs["x"] = rng.uniform(0, 10, 400)
    locs["photons"] = rng.uniform(100, 5000, 400)
    locs["group"] = rng.permutation(np.repeat([7, 3, 11, 0, 5], 80))
    df = _df(locs)

    def same(got, ref):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b.to_records(index=False)
                                          .astype(a.dtype))

    for kw in ({}, {"n_colors": 5, "min_value": 1000.0, "max_value": 4000.0}):
        same(trender.split_locs_by_property(locs, property_name="photons",
                                            **kw),
             jrender.split_locs_by_property(df, property_name="photons",
                                            **kw))
    same(trender.split_locs_by_group(locs), jrender.split_locs_by_group(df))
    colour = locs["group"] % 4
    same(trender.split_locs_by_group(locs, 4, colour),
         jrender.split_locs_by_group(df, 4, colour))
    same(trender.split_locs_by_group(locs[["x", "photons"]]),
         jrender.split_locs_by_group(df[["x", "photons"]]))


# ---------------------------------------------------------------------------
# the render index and profiling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,size", [(0, 64), (20000, 256), (5000, 1000)])
def test_render_index_matches_jax_bit_for_bit(n, size):
    rng = np.random.default_rng(n)
    locs = np.zeros(n, [("x", np.float32), ("y", np.float32)])
    locs["x"] = rng.uniform(0, size, n)
    locs["y"] = rng.uniform(0, size * 0.75, n)
    info = [{"Width": size, "Height": int(size * 0.75)}]
    got = tindex.build_render_index(locs, info)
    ref = jindex.build_render_index(_df(locs), info)
    np.testing.assert_array_equal(got.perm, ref.perm)
    assert got.perm.dtype == ref.perm.dtype
    assert (got.block_sizes, got.width, got.height) == (
        ref.block_sizes, ref.width, ref.height)
    for a, b in zip(got.block_starts + got.block_ends,
                    ref.block_starts + ref.block_ends):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for vp in (((0, 0), (size, size)), ((3.5, 7.2), (13.0, 20.1)),
               ((size * 0.2, size * 0.3), (size * 0.31, size * 0.45)),
               ((-5, -5), (2, 2)), ((size + 1, size + 1), (size + 9,
                                                           size + 9))):
        a, b = (tindex.query_viewport(got, vp),
                jindex.query_viewport(ref, vp))
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
            (y0, x0), (y1, x1) = vp
            inside = np.nonzero((locs["x"] >= x0) & (locs["x"] < x1)
                                & (locs["y"] >= y0) & (locs["y"] < y1))[0]
            assert set(inside) <= set(a.tolist())


def test_profiling_traces_annotates_and_times(tmp_path):
    """trace writes a Chrome trace holding the annotated span (JAX writes
    TensorBoard files there); no directory, no trace."""
    @tprof.annotate("render3d-span")
    def work():
        return torch.ones(64).sum()

    with tprof.trace(None) as none:
        work()
    assert none is None
    with jprof.trace(None) as jnone:
        pass
    assert jnone is None
    with tprof.trace(str(tmp_path / "tr")) as where:
        assert work() == 64
    assert where == str(tmp_path / "tr")
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "render3d-span" for e in events)
    with pytest.raises(ValueError):
        with tprof.trace(str(tmp_path / "raised")):
            raise ValueError
    assert os.path.exists(tmp_path / "raised" / "trace.json")


def test_rotated_and_3d_entry_points_need_the_card_or_cpu():
    """Without device="cpu" and without a card the rotated render, the
    rotation of locs, the 3D histograms and the scene raise; the colour
    helpers, the render index and render_hist_numba take no device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    locs = _locs3d(n=100)
    x, y, z = locs["x"], locs["y"], locs["z"]
    calls = [
        lambda: trender.render(locs, _info(), ang=ANG, blur_method="gaussian"),
        lambda: trender.locs_rotation(locs, 1.0, 0, 8, 0, 8, ANG),
        lambda: trender.render_hist3d(x, y, z, 1.0, 0, 0, 8, 8, -1, 1, 130),
        lambda: trender.render_hist3d_anisotropic(x, y, z, 1.0, 1.0, 0, 0, 8,
                                                  8, -1, 1, 130),
        lambda: trender.render_hist_anisotropic(x, y, 1.0, 1.0, 0, 0, 8, 8),
        lambda: trender.render_scene(locs, _info()),
        lambda: trender.render_gaussian(locs, 1.0, 0, 0, 8, 8, 0.0, ANG),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    trender.render_hist_numba(x, y, 1.0, 0.0, 8.0)
    tindex.query_viewport(tindex.build_render_index(locs, _info()),
                          ((0, 0), (4, 4)))
