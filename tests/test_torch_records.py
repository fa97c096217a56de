"""Locs records on a device (picasso_torch/ops/records.py): the layout
that apply_drift writes, and the columns that the RCC segments read
from the records against render.columns', on the CPU. apply_drift
itself is held to the JAX package's over many record layouts in
tests/test_torch_undrift.py.

Tests marked ``cuda`` hold csrc/records.cu to its plain version byte for
byte on the card; they skip where no card is visible. This file imports
no JAX:

    python -m pytest tests/test_torch_records.py -m cuda --noconftest
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from picasso_torch import postprocess, render
from picasso_torch.ops import records
from torch_records_data import (DTYPES, MLE, N_FRAMES, make_drift,
                                make_locs, same_bytes)


def test_drift_layout_merges_the_runs_that_are_not_moved():
    layout, table = records.drift_layout(MLE, make_drift("rec2", seed=7))
    assert layout.out_dtype.itemsize == 76 and table.shape == (N_FRAMES, 2)
    # frame, x, y, then the 14 other fields in one run of 56 bytes
    np.testing.assert_array_equal(layout.segments, [
        [records.COPY, 0, 0, 4, 0], [records.SUBTRACT, 4, 4, 4, 0],
        [records.SUBTRACT, 8, 12, 4, 1], [records.COPY, 12, 20, 56, 0]])
    assert layout.frame == (0, 4, False)
    aligned, _ = records.drift_layout(DTYPES["aligned"],
                                      make_drift("array2", seed=7))
    # the padding after frame and flag is not copied
    assert [row[3] for row in aligned.segments.tolist()] == [2, 4, 1, 8, 4]


@pytest.mark.parametrize("kind", ["mle", "aligned", "packed-odd"])
def test_columns_from_the_records_equal_render_columns(kind):
    locs = make_locs(DTYPES[kind], 500, seed=8)
    recs = records.upload(locs, "cpu")
    names = [n for n in ("x", "y", "lpx", "lpy") if n in locs.dtype.names]
    want = render.columns(locs, names, "cpu")
    for n in names:
        got = records.column(recs, locs.dtype, n)
        assert got.dtype == want[n].dtype
        torch.testing.assert_close(got, want[n], rtol=0, atol=0)
    np.testing.assert_array_equal(
        records.column(recs, locs.dtype, "frame").numpy(),
        locs["frame"].astype(np.int64))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _kernel_and_plain(locs, drift, dev):
    layout, table = records.drift_layout(locs.dtype, drift)
    table = torch.from_numpy(table)
    plain = records.apply_drift_records_plain(records.upload(locs, "cpu"),
                                              layout, table)
    before = records.apply_drift_records.launches
    got = records.apply_drift_records(records.upload(locs, dev), layout,
                                      table.to(dev))
    torch.cuda.synchronize()
    assert records.apply_drift_records.launches == before + 1
    return (records.download(got, layout.out_dtype),
            records.download(plain, layout.out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, (1 << 20) - 3])
@pytest.mark.parametrize("kind", list(DTYPES))
def test_record_kernel_equals_the_plain_version(dev, kind, n):
    locs = make_locs(DTYPES[kind], n, seed=n % 1000,
                     negative_frames=DTYPES[kind]["frame"].kind == "i")
    form = "rec3" if kind == "3d" else "rec2"
    got, plain = _kernel_and_plain(locs, make_drift(form, seed=9), dev)
    same_bytes(got, plain)


@pytest.mark.cuda
def test_record_kernel_raises_index_error_for_a_frame_outside(dev):
    locs = make_locs(MLE, 5000, seed=10)
    locs["frame"][4321] = N_FRAMES
    with pytest.raises(IndexError, match="out of bounds"):
        postprocess.apply_drift(locs, [{}], drift=make_drift("rec2", seed=1),
                                device=dev)


@pytest.mark.cuda
def test_undrift_on_the_card_launches_the_record_kernel_once(dev):
    rng = np.random.default_rng(11)
    locs = make_locs(MLE, 20000, seed=11)
    locs["frame"] = np.sort(rng.integers(0, 400, len(locs)))
    locs["x"] = rng.uniform(2, 30, len(locs))
    locs["y"] = rng.uniform(2, 30, len(locs))
    locs["lpx"] = locs["lpy"] = 0.1
    info = [{"Frames": 400, "Height": 32, "Width": 32}]
    for _ in range(2):
        before = records.apply_drift_records.launches
        drift, out = postprocess.undrift(locs, info, 100, device=dev)
        assert records.apply_drift_records.launches == before + 1
        same_bytes(out, postprocess.apply_drift(locs, info, drift=drift,
                                                device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mle", "aligned", "packed-odd"])
def test_columns_from_the_records_on_the_card_equal_render_columns(dev,
                                                                   kind):
    locs = make_locs(DTYPES[kind], 4099, seed=12)
    recs = records.upload(locs, dev)
    names = [n for n in ("x", "y", "lpx", "lpy") if n in locs.dtype.names]
    want = render.columns(locs, names, dev)
    for n in names:
        got = records.column(recs, locs.dtype, n)
        assert got.device == want[n].device and got.dtype == want[n].dtype
        assert torch.equal(got, want[n])
    np.testing.assert_array_equal(
        records.column(recs, locs.dtype, "frame").cpu().numpy(),
        locs["frame"].astype(np.int64))
