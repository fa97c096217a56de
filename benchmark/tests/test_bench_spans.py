"""The readers of the program's spans (``core/spans.py`` and the metrics
that read ``picasso.*`` spans) on synthetic traces: clipping to the
window, nested and repeated spans, a missing span; and one traced small
run of each cell on the CPU, in which every such metric reads a finite
value."""

from __future__ import annotations

import math

import pytest

from conftest import SMALL, SMALL_DRIFT
from core import spans
from core import trace as trace_mod
from core.harness import run_cell
from core.spec import load_module, load_spec, metric_path

SEED = 2 ** 33 + 5
SPAN_METRICS = {
    "localize.gather_s": "picasso.localize.gather",
    "localize.locs_table_s": "picasso.localize.locs_table",
    "stream.decode_wait_s": "picasso.stream.decode_wait",
    "fused.identify_s": "picasso.fused.identify",
    "undrift.segment_s": "picasso.undrift.segment",
    "undrift.xcorr_s": "picasso.undrift.xcorr",
    "undrift.peak_fit_s": "picasso.undrift.peak_fit",
    "undrift.apply_s": "picasso.undrift.apply",
}
NEW_METRICS = [*SPAN_METRICS, "stream.h2d_gbps"]


def _ev(name, start, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": start * 1e6,
            "dur": dur * 1e6}


def _trace(*events, window=(1.0, 9.0)):
    lo, hi = window
    return trace_mod.from_chrome([_ev("bench.window", lo, hi - lo),
                                  *events])


def _read(name, record):
    return load_module(metric_path(name),
                       "m_" + name.replace(".", "_")).read(record)


def test_a_span_is_clipped_to_the_window():
    tr = _trace(_ev("picasso.localize.gather", 0.5, 1.0),
                _ev("picasso.localize.gather", 8.5, 2.0))
    assert spans.intervals(tr, "picasso.localize.gather") == [
        (1.0, 1.5), (8.5, 9.0)]
    assert spans.seconds(tr, "picasso.localize.gather") == pytest.approx(1.0)


def test_repeated_spans_add_and_nested_ones_count_once():
    tr = _trace(_ev("picasso.undrift.solve", 2.0, 1.0),
                _ev("picasso.undrift.solve", 2.25, 0.5),  # nested in itself
                _ev("picasso.undrift.solve", 5.0, 0.5),
                _ev("picasso.undrift", 1.5, 6.0),  # a parent: not read
                _ev("picasso.undrift.solver", 4.0, 1.0))  # another name
    assert spans.seconds(tr, "picasso.undrift.solve") == pytest.approx(1.5)
    record = {"trace": tr, "calls": [{}, {}, {}]}
    assert spans.per_call(record, "picasso.undrift.solve") == \
        pytest.approx(0.5)


def test_a_missing_span_or_trace_reads_none():
    tr = _trace(_ev("picasso.undrift.xcorr", 9.5, 1.0),  # after the window
                _ev("aten::copy_", 2.0, 1.0, "cpu_op"))
    calls = [{"perf": None}]
    for name in NEW_METRICS:
        assert _read(name, {"trace": tr, "calls": calls}) is None, name
        assert _read(name, {"trace": None, "calls": calls}) is None, name
    assert spans.per_call({"trace": tr, "calls": []},
                          "picasso.undrift.xcorr") is None
    assert spans.seconds(trace_mod.Trace(), "picasso.undrift.xcorr") is None


def test_each_span_metric_reads_its_span_a_call():
    events = [_ev(span, 2.0 + i * 0.5, 0.25 * (i + 1))
              for i, span in enumerate(SPAN_METRICS.values())]
    tr = _trace(*events)
    record = {"trace": tr, "calls": [{}, {}]}
    for i, name in enumerate(SPAN_METRICS):
        assert _read(name, record) == pytest.approx(0.25 * (i + 1) / 2), name


def test_the_upload_rate_divides_window_totals():
    tr = _trace(_ev("picasso.stream.upload", 2.0, 0.5),
                _ev("picasso.stream.upload", 4.0, 1.5),
                _ev("picasso.stream.upload", 8.5, 1.0))  # 0.5 s inside
    calls = [{"perf": {"upload_bytes": 3e9}}, {"perf": {"upload_bytes": 2e9}},
             {"perf": None}]
    assert _read("stream.h2d_gbps", {"trace": tr, "calls": calls}) == \
        pytest.approx(5e9 / 2.5 / 1e9)
    # a program without the counter, or without the span: nothing
    calls = [{"perf": {"total_s": 1.0}}]
    assert _read("stream.h2d_gbps", {"trace": tr, "calls": calls}) is None
    calls = [{"perf": {"upload_bytes": 1}}]
    assert _read("stream.h2d_gbps", {"trace": _trace(),
                                     "calls": calls}) is None


def test_idle_time_outside_the_programs_spans():
    # device busy 2-3 and 6-7 of the window 1-9: idle 1-2, 3-6, 7-9 (6 s);
    # picasso spans cover 1.5-2, 3-3.5 and 4-5 of it (2 s), bench spans do
    # not
    tr = _trace(_ev("k", 2.0, 1.0, "kernel"), _ev("k", 6.0, 1.0, "kernel"),
                _ev("picasso.localize", 1.5, 2.0),
                _ev("picasso.localize.gather", 4.0, 1.0),
                _ev("bench.localize", 1.0, 8.0))
    assert spans.idle_outside_share(tr) == pytest.approx(1 - 2 / 6)
    assert spans.idle_outside_share(None) is None
    busy = _trace(_ev("k", 0.0, 10.0, "kernel"))
    assert spans.idle_outside_share(busy) is None


def test_the_new_metrics_are_program_spans_of_their_cells():
    spec = load_spec()
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW_METRICS:
        m = entries[name]
        assert m["source"] == "program_span"
        cell = ("2d-b7-rcc-undrift" if name.startswith("undrift.")
                else "2d-b7-mle-dense")
        assert m["workloads"] == [cell]


@pytest.mark.parametrize("cell,sizes,names", [
    ("2d-b7-mle-dense", SMALL,
     [n for n in NEW_METRICS if not n.startswith("undrift.")]),
    ("2d-b7-rcc-undrift", SMALL_DRIFT,
     [n for n in NEW_METRICS if n.startswith("undrift.")])])
def test_a_traced_small_run_reads_every_new_metric(cell, sizes, names):
    result = run_cell(cell, SEED, 0.5, True, device="cpu", sizes=sizes,
                      check_device=False)
    assert result["correct"], result["checks"]
    for name in names:
        assert name in result["metrics"], name
        assert math.isfinite(result["metrics"][name]["value"]), name
        assert result["metrics"][name]["value"] > 0, name
