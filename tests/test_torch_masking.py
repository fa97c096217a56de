"""The Mask tool of the port held against picasso_tpu on the CPU:
generate_image, every threshold of THRESHOLD_METHODS, mask_image,
binary_mask and mask_locs.

Inputs: tests/torch_data.make_origami_locs and seeded numpy images.
Tolerances (tests/torch_parity.py): bit for bit. generate_image renders
its histogram through render.render (integer counts in f32, the same on
any device) and blurs it with scipy on the host, as JAX; the thresholds
and masks are the same numpy and scipy code. mask_locs' two tables are
sorted by frame stably (JAX's pandas quicksort may reorder the rows of
one frame), so they are compared with JAX's as sets of rows, and in
order where a frame holds one loc.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest

from picasso_torch import masking as tm
from picasso_tpu import masking as jm
from torch_data import make_origami_locs

CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def field():
    locs, info, _ = make_origami_locs(25, 6)
    return locs, info


def _images(field):
    """generate_image of the field and two seeded images: one of a few
    values (ties in the histogram) and a smooth bimodal one."""
    locs, info = field
    rng = np.random.default_rng(2)
    steps = rng.integers(0, 4, (40, 40)).astype(np.float32) / 3
    yy, xx = np.mgrid[:64, :64]
    blobs = (np.exp(-((xx - 20) ** 2 + (yy - 30) ** 2) / 60.0)
             + 0.6 * np.exp(-((xx - 45) ** 2 + (yy - 20) ** 2) / 30.0)
             + rng.normal(0, 0.02, (64, 64)))
    return [tm.generate_image(locs, info, 65.0, 100.0, **CPU), steps,
            blobs]


@pytest.mark.parametrize("px,blur", [(65.0, 100.0), (130.0, 50.0),
                                     (20.0, 30.0)])
def test_generate_image_matches_jax(field, px, blur):
    locs, info = field
    got = tm.generate_image(locs, info, px, blur, **CPU)
    want = jm.generate_image(pd.DataFrame(locs), info, px, blur)
    assert got.dtype == want.dtype and got.max() == 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", list(jm.THRESHOLD_METHODS))
def test_thresholds_and_masks_match_jax(field, method):
    """Every method's threshold (global) or mask (local) and mask_image's
    mask on three images."""
    assert tm.THRESHOLD_METHODS == jm.THRESHOLD_METHODS
    for image in _images(field):
        got = getattr(tm, f"threshold_{method}")(image)
        want = getattr(jm, f"threshold_{method}")(image)
        np.testing.assert_array_equal(got, want)
        assert type(got) is type(want)
        mask = tm.mask_image(image, method)
        assert mask.dtype == bool
        np.testing.assert_array_equal(mask, jm.mask_image(image, method))


def test_threshold_edge_cases_match_jax():
    """A constant image and one with a single nonzero pixel."""
    one = np.zeros((8, 8))
    one[3, 4] = 1.0
    for image in (np.full((6, 6), 0.5), one):
        for method in ("isodata", "li", "mean", "minimum", "otsu",
                       "triangle", "yen"):
            got = getattr(tm, f"threshold_{method}")(image)
            want = getattr(jm, f"threshold_{method}")(image)
            np.testing.assert_array_equal(got, want, err_msg=method)


def test_binary_mask_matches_jax():
    rng = np.random.default_rng(3)
    image = rng.random((9, 7))
    for threshold in (0.4, rng.random((9, 7))):
        np.testing.assert_array_equal(tm.binary_mask(image, threshold),
                                      jm.binary_mask(image, threshold))
    for mod in (tm, jm):
        with pytest.raises(ValueError, match="same shape"):
            mod.binary_mask(image, rng.random((7, 9)))


def _rows(table) -> set:
    rec = (table.to_records(index=False) if isinstance(table, pd.DataFrame)
           else table)
    return set(map(tuple, rec.tolist()))


def test_mask_locs_matches_jax(field):
    """With Otsu's mask of the left half of the field: inside + outside =
    all; each is JAX's set of rows, sorted by frame
    stably; the size from ``info`` or from width and height; without
    either it raises."""
    locs, info = field
    image = tm.generate_image(locs, info, 65.0, 100.0, **CPU)
    mask = tm.mask_image(image, "otsu")
    mask[:, : mask.shape[1] // 2] = False  # the left half's locs outside
    inside, outside = tm.mask_locs(locs, mask, info=info)
    j_in, j_out = jm.mask_locs(pd.DataFrame(locs), mask, info=info)
    assert len(inside) + len(outside) == len(locs)
    assert 0 < len(inside) < len(locs)
    assert _rows(inside) == _rows(j_in) and _rows(outside) == _rows(j_out)
    for part in (inside, outside):
        assert part.dtype == locs.dtype
        assert np.all(np.diff(part["frame"].astype(np.int64)) >= 0)
    again = tm.mask_locs(locs, mask, info[0]["Width"], info[0]["Height"])
    for a, b in zip(again, (inside, outside)):
        np.testing.assert_array_equal(a, b)
    one = locs[np.sort(np.unique(locs["frame"], return_index=True)[1])]
    for a, b in zip(tm.mask_locs(one, mask, info=info),
                    jm.mask_locs(pd.DataFrame(one), mask, info=info)):
        np.testing.assert_array_equal(a, b.to_records(index=False))
    for mod, table in ((tm, locs), (jm, pd.DataFrame(locs))):
        with pytest.raises(ValueError, match="requires `info`"):
            mod.mask_locs(table, mask)
