"""The port's spans (picasso_torch/profiling.span) on the CPU: off, a
span opens no ``record_function`` and still times its block into
``perf``; under torch.profiler, localize's and undrift's steps appear in
the Chrome trace under their names, nested as the program nests them,
and tracing changes no result; the ``perf`` split of localize_fused
still sums to its total and counts the bytes uploaded.
Inputs: tests/torch_data.make_bench_movie(24, 32, 12, 0.5, rng(3)) (u16)
and random locs of 96 frames on a 32 x 32 field.
"""

from __future__ import annotations

import json
import time
from unittest import mock

import numpy as np
import pytest
import torch

from picasso_torch import localize as tloc
from picasso_torch import postprocess as tpost
from picasso_torch import profiling as tprof
from picasso_torch.ops import fused as tfused
from picasso_torch.parallel.mesh import Mesh
from torch_data import make_bench_movie

CAMERA = {"Baseline": 0, "Sensitivity": 1, "Gain": 1, "Pixelsize": 130}
PARAMS = {"Min. Net Gradient": 4000, "Box Size": 7}
#: the perf parts' rounding to ms, as test_torch_localize_api allows
PERF_ROUNDING = 0.003
#: each span's parent on the localize path (one device) and in undrift
LOCALIZE_NEST = {
    "picasso.localize": None,
    "picasso.stream.decode_wait": "picasso.localize",
    "picasso.stream.upload": "picasso.localize",
    "picasso.fused.chain": "picasso.localize",
    "picasso.fused.identify": "picasso.fused.chain",
    "picasso.fused.fit": "picasso.fused.chain",
    "picasso.fused.pack": "picasso.fused.chain",
    "picasso.fused.drain": "picasso.localize",
    "picasso.localize.gather": "picasso.localize",
    "picasso.localize.locs_table": "picasso.localize",
}
UNDRIFT_NEST = {
    "picasso.undrift": None,
    "picasso.undrift.upload": "picasso.undrift",
    "picasso.undrift.segment": "picasso.undrift",
    "picasso.undrift.xcorr": "picasso.undrift",
    "picasso.undrift.peak_fit": "picasso.undrift",
    "picasso.undrift.solve": "picasso.undrift",
    "picasso.undrift.apply": "picasso.undrift",
}


@pytest.fixture(scope="module")
def movie():
    return make_bench_movie(24, 32, 12, 0.5, np.random.default_rng(3))


def _undrift_inputs(n_frames=96, size=32, seed=4):
    """Locs of 20 sites blinking over ``n_frames`` frames, 0.1 px of
    scatter, drifting 0.5 px in x; four segments of 24 frames."""
    rng = np.random.default_rng(seed)
    sites = rng.uniform(4, size - 4, (20, 2))
    frame = np.repeat(np.arange(n_frames), 10)
    site = rng.integers(0, len(sites), len(frame))
    locs = np.zeros(len(frame), [("frame", np.uint32), ("x", np.float32),
                                 ("y", np.float32), ("lpx", np.float32),
                                 ("lpy", np.float32)])
    locs["frame"] = frame
    locs["x"] = sites[site, 1] + rng.normal(0, 0.1, len(frame)) \
        + 0.5 * frame / n_frames
    locs["y"] = sites[site, 0] + rng.normal(0, 0.1, len(frame))
    locs["lpx"] = locs["lpy"] = 0.1
    info = [{"Frames": n_frames, "Height": size, "Width": size}]
    return locs, info, 24


def _traced(tmp_path, fn):
    """fn() under a CPU profile; (its result, the picasso.* spans as
    {name: [(start, end) µs, ...]})."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans: dict[str, list] = {}
    for ev in json.loads(path.read_text())["traceEvents"]:
        name = str(ev.get("name", ""))
        if ev.get("ph") == "X" and name.startswith("picasso."):
            spans.setdefault(name, []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
    return out, spans


def _assert_nested(spans, nest):
    """Every span of ``nest`` is there, each inside one of its parent's."""
    assert set(nest) <= set(spans), sorted(set(nest) - set(spans))
    for name, parent in nest.items():
        for a, b in spans[name]:
            assert b >= a
            if parent is not None:
                assert any(pa - 1 <= a and b <= pb + 1
                           for pa, pb in spans[parent]), (name, parent)


def test_a_span_off_opens_no_record_function_and_still_times():
    assert not tprof._profiler_enabled()
    perf = {"decode_wait_s": 0.5}
    with mock.patch.object(torch.profiler, "record_function") as rf:
        with tprof.span("picasso.stream.decode_wait", perf, "decode_wait_s"):
            time.sleep(0.002)
        with tprof.span("picasso.fused.pack"):
            pass
        tprof.annotate("picasso.undrift.apply")(lambda: None)()
    rf.assert_not_called()
    assert perf["decode_wait_s"] >= 0.502 and list(perf) == ["decode_wait_s"]
    with tprof.span("picasso.stream.upload", perf, "upload_dispatch_s"):
        pass
    assert perf["upload_dispatch_s"] >= 0


def test_a_span_on_records_and_closes_when_its_block_raises(tmp_path):
    perf = {}

    def work():
        with tprof.span("picasso.test.outer", perf, "outer_s"):
            with pytest.raises(ValueError):
                with tprof.span("picasso.test.inner"):
                    raise ValueError
        return 1

    with mock.patch.object(torch.profiler, "record_function",
                           wraps=torch.profiler.record_function) as rf:
        out, spans = _traced(tmp_path, work)
    assert out == 1 and rf.call_count == 2 and perf["outer_s"] > 0
    _assert_nested(spans, {"picasso.test.outer": None,
                           "picasso.test.inner": "picasso.test.outer"})


def test_localize_writes_its_spans_and_the_same_locs(tmp_path, movie):
    want = tloc.localize(movie, dict(CAMERA), PARAMS,
                         fitting_method="gaussmle", device="cpu")
    perf = {}
    got, spans = _traced(tmp_path, lambda: tloc.localize(
        movie, dict(CAMERA), PARAMS, fitting_method="gaussmle", perf=perf,
        device="cpu"))
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)
    _assert_nested(spans, LOCALIZE_NEST)
    assert len(spans["picasso.localize"]) == 1
    for name in ("picasso.stream.upload", "picasso.fused.chain",
                 "picasso.fused.identify", "picasso.fused.fit",
                 "picasso.fused.drain"):
        assert len(spans[name]) == perf["n_chunks"], name
    assert "picasso.fused.mesh_chain" not in spans


def test_localize_over_a_mesh_writes_the_mesh_chain(tmp_path, movie):
    perf = {}
    got, spans = _traced(tmp_path, lambda: tfused.localize_fused(
        movie, 4000, 7, dict(CAMERA), frame_chunk=8, perf=perf,
        device=Mesh(["cpu"] * 2)))
    want = tfused.localize_fused(movie, 4000, 7, dict(CAMERA), frame_chunk=8,
                                 device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert len(spans["picasso.fused.mesh_chain"]) == perf["n_chunks"] == 3
    assert len(spans["picasso.fused.drain"]) == 3
    assert "picasso.stream.upload" not in spans
    assert "picasso.fused.chain" not in spans
    assert perf["upload_bytes"] == 0 and perf["upload_dispatch_s"] == 0


def test_undrift_writes_its_six_spans_and_the_same_drift(tmp_path):
    locs, info, seg = _undrift_inputs()
    want = tpost.undrift(locs, info, seg, device="cpu")
    got, spans = _traced(tmp_path, lambda: tpost.undrift(
        locs, info, seg, device="cpu"))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    _assert_nested(spans, UNDRIFT_NEST)
    assert len(spans["picasso.undrift"]) == 1
    # least squares in rcc, the two splines in undrift
    assert len(spans["picasso.undrift.solve"]) == 2


@pytest.mark.parametrize("frame_chunk", [None, 5])
def test_perf_parts_sum_to_the_total_and_count_the_uploaded_bytes(
        movie, frame_chunk):
    perf = {}
    tfused.localize_fused(movie, 4000, 7, dict(CAMERA),
                          frame_chunk=frame_chunk, perf=perf, device="cpu")
    assert list(perf) == ["n_chunks", "frame_chunk", "decode_wait_s",
                          "upload_dispatch_s", "chain_dispatch_s", "drain_s",
                          "other_s", "total_s", "upload_bytes"]
    assert perf["n_chunks"] == (1 if frame_chunk is None else 5)
    parts = sum(perf[k] for k in ("decode_wait_s", "upload_dispatch_s",
                                  "chain_dispatch_s", "drain_s", "other_s"))
    assert abs(parts - perf["total_s"]) <= PERF_ROUNDING
    assert perf["upload_bytes"] == movie.nbytes
    roi = ((2, 3), (30, 27))
    perf = {}
    tfused.localize_fused(movie, 4000, 7, dict(CAMERA), roi=roi,
                          frame_bounds=(4, 19), frame_chunk=frame_chunk,
                          perf=perf, device="cpu")
    assert perf["upload_bytes"] == movie[4:20, 2:30, 3:27].nbytes


def test_perf_is_written_anew_by_each_call(movie):
    perf = {}
    tfused.localize_fused(movie, 4000, 7, dict(CAMERA), frame_chunk=5,
                          perf=perf, device="cpu")
    first = perf["upload_bytes"]
    tfused.localize_fused(movie, 4000, 7, dict(CAMERA), frame_chunk=5,
                          perf=perf, device="cpu")
    assert perf["upload_bytes"] == first and perf["n_chunks"] == 5
