"""Rendering of the port (picasso_torch.render, ops/render_ops) held
against picasso_tpu on the CPU, for every blur mode, f32 and f64
coordinates, and both of JAX's routes (below and from 50,000 locs in
view: the host route in the coordinates' dtype, the device route in
f32).

Tolerances, with the spread measured on the CPU (numpy 2, scipy 1.17,
torch 2.13):
- histograms, ``smooth`` and ``convolve`` equal: the counts are exact
  and the port's filter takes scipy's terms in scipy's order in f64;
- ``gaussian`` and ``gaussian_iso`` within rtol 1e-5 + atol 1e-6: the
  splat sums its windows in another order, and on the host route in f64
  (measured max 2.0e-7 of the image max over the cases below).
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch
from scipy import ndimage

from picasso_tpu import render as jrender
from picasso_torch import render as trender
from picasso_torch.ops import render_ops

SIZE = 256
VIEWPORT = ((10.3, 20.7), (200.1, 230.9))
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _info(frames=100, size=SIZE):
    return [{"Byte Order": "<", "Data Type": "uint16", "Frames": frames,
             "Height": size, "Width": size, "Pixelsize": 130}]


_CACHE: dict = {}


def _locs(n: int, dtype, seed: int = 3) -> np.ndarray:
    """``n`` random locs over the field (some outside it) with
    precisions of 0.02-0.3 px, x and y in ``dtype`` (f64 as a drift
    correction leaves them)."""
    key = (n, np.dtype(dtype).str, seed)
    if key not in _CACHE:
        rng = np.random.default_rng(seed)
        locs = np.zeros(n, [("frame", np.uint32), ("x", dtype),
                            ("y", dtype), ("lpx", np.float32),
                            ("lpy", np.float32)])
        locs["frame"] = rng.integers(0, 100, n)
        for c in ("x", "y"):
            locs[c] = rng.uniform(-1, SIZE + 1, n)
        locs["lpx"] = rng.uniform(0.02, 0.3, n)
        locs["lpy"] = rng.uniform(0.02, 0.3, n)
        _CACHE[key] = locs
    return _CACHE[key]


def _both(locs, info, **kw):
    n_j, img_j = jrender.render(pd.DataFrame.from_records(locs), info, **kw)
    n_t, img_t = trender.render(locs, info, **kw, device="cpu")
    assert n_t == n_j and img_t.shape == img_j.shape
    assert img_t.dtype == np.float32
    return img_j, img_t


def _check(blur, img_j, img_t):
    if blur in (None, "smooth", "convolve"):
        np.testing.assert_array_equal(img_t, img_j)
    else:
        np.testing.assert_allclose(img_t, img_j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("blur", [None, "gaussian"])
@pytest.mark.parametrize("oversampling", [1.0, 7.3, 10.0])
@pytest.mark.parametrize("n", [20_000, 200_000])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_render_f64_coords_match_jax(dtype, n, oversampling, blur):
    """The in-view test and the display transform run in the locs'
    dtype; below 50,000 locs a coordinate is truncated to a pixel and
    bounds its window in that dtype, from 50,000 on after a cast to f32,
    on each of JAX's routes."""
    img_j, img_t = _both(_locs(n, dtype), _info(), oversampling=oversampling,
                         viewport=VIEWPORT, blur_method=blur)
    _check(blur, img_j, img_t)


@pytest.mark.parametrize("blur", ["gaussian_iso", "smooth", "convolve"])
@pytest.mark.parametrize("n", [20_000, 200_000])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_blur_modes_match_jax(dtype, n, blur):
    img_j, img_t = _both(_locs(n, dtype), _info(), oversampling=7.3,
                         viewport=VIEWPORT, blur_method=blur,
                         min_blur_width=0.0)
    _check(blur, img_j, img_t)


@pytest.mark.parametrize("blur", [None, "gaussian", "gaussian_iso", "smooth",
                                  "convolve"])
def test_whole_field_and_min_blur_width_match_jax(blur):
    """The default viewport (the whole frame), a min_blur_width that
    wins over most precisions (and over the medians of convolve), and
    display pixels given in nm."""
    locs = _locs(20_000, np.float64, seed=4)
    for kw in (dict(oversampling=2.0, min_blur_width=0.2),
               dict(disp_px_size=26.0, min_blur_width=0.0)):
        img_j, img_t = _both(locs, _info(), blur_method=blur, **kw)
        _check(blur, img_j, img_t)


def test_wide_windows_on_the_device_route_match_jax():
    """Windows wider than JAX's 128-pixel tile: cut to +-63 pixels from
    50,000 locs on, drawn whole below."""
    for n in (60_000, 2_000):
        locs = _locs(n, np.float32, seed=5).copy()
        locs["lpx"][::50] = 4.0
        img_j, img_t = _both(locs, _info(), oversampling=10.0,
                             viewport=((100, 100), (140, 140)),
                             blur_method="gaussian")
        _check("gaussian", img_j, img_t)


def test_empty_view_and_bad_blur():
    locs = _locs(20_000, np.float32)
    for blur in (None, "gaussian", "smooth", "convolve"):
        img_j, img_t = _both(locs, _info(), viewport=((300, 300), (310, 320)),
                             blur_method=blur)
        assert img_t.shape == (10, 20) and not img_t.any()
        _check(blur, img_j, img_t)
    with pytest.raises(ValueError, match="not understood"):
        trender.render(locs, _info(), blur_method="box", device="cpu")
    with pytest.raises(ValueError, match="Need info"):
        trender.render(locs, None, device="cpu")


def test_render_hist_matches_jax():
    locs = _locs(20_000, np.float64)
    n_j, img_j = jrender.render_hist(pd.DataFrame.from_records(locs), 3.0,
                                     5.5, 7.25, 60.0, 90.0)
    n_t, img_t = trender.render_hist(locs, 3.0, 5.5, 7.25, 60.0, 90.0,
                                     device="cpu")
    assert n_t == n_j
    np.testing.assert_array_equal(img_t, img_j)


@pytest.mark.parametrize("sigmas", [
    (1, 1), (np.float32(0.73), np.float32(2.9)), (3.4, 0.2),
    (np.float32(0.0), 1.5)])
def test_gaussian_filter_equals_scipy(sigmas):
    """Bit for bit, at int, f32 and f64 sigmas, and with an axis of
    sigma 0 (skipped, as scipy skips it)."""
    rng = np.random.default_rng(2)
    image = rng.poisson(0.7, (61, 77)).astype(np.float32)
    want = np.empty_like(image)
    ndimage.gaussian_filter(image, sigma=sigmas, output=want,
                            mode="constant", cval=0.0, truncate=5.0)
    got = render_ops.gaussian_filter(torch.from_numpy(image), *sigmas)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("autoscale", [False, True])
def test_scale_contrast_matches_jax(autoscale):
    rng = np.random.default_rng(6)
    image = rng.gamma(0.5, 3.0, (40, 50)).astype(np.float32)
    stack = np.stack([image, 2 * image, np.zeros_like(image)])
    for img in (image, stack):
        for kw in (dict(), dict(vmin=0.5, vmax=4.0)):
            t = trender.scale_contrast(img, autoscale=autoscale,
                                       return_contrast_limits=True, **kw)
            j = jrender.scale_contrast(img, autoscale=autoscale,
                                       return_contrast_limits=True, **kw)
            np.testing.assert_array_equal(t[0], j[0])
            assert t[1] == j[1]
    flat = np.ones((4, 4), np.float32)
    np.testing.assert_array_equal(trender.scale_contrast(flat),
                                  jrender.scale_contrast(flat))


def test_percentile_equals_numpy():
    from picasso_torch.imageprocess import percentile_linear

    rng = np.random.default_rng(7)
    for n in (1, 2, 7, 100, 4097):
        v = (rng.random(n) * 300).astype(np.float32)
        v[rng.random(n) < 0.5] = 0
        for q in (0, 37.5, 99, 100):
            got = percentile_linear(torch.from_numpy(v), q)
            want = np.percentile(v, q)
            assert got == want and type(got) is type(want)
    v[3] = np.nan
    assert np.isnan(percentile_linear(torch.from_numpy(v), 99))
