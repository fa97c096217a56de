"""The harness: BENCHMARK.json against the contract it is written to,
every name resolving to its files, the metric readers on a canned trace
and record, and a run without a card failing without a result."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT
from core import device as dev_info
from core import trace as trace_mod
from core.spec import (NAME_RE, UNIT_RE, Cell, cell_metrics, config_path,
                       driver_path, generator_path, limits_path, load_module,
                       load_spec, metric_path, traffic_path)
from reference import locs as ref_locs

SPEC = load_spec()
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert (ROOT / SPEC["command"][1]).is_file()


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51 and isinstance(rs, int)
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lengths():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in SPEC[key]]
    assert all(NAME_RE.match(n) for n in names), names
    for key in ("configs", "workloads"):
        assert len({e["name"] for e in SPEC[key]}) == len(SPEC[key])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT_RE.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in SPEC["workloads"]:
        assert NAME_RE.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in SPEC["configs"]:
        assert 1 <= len(c["source"]) <= 200 and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/")


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in SPEC["workloads"]}
    for w in cells:
        reported, layer = cell_metrics(SPEC, w)
        assert len(reported) >= 2 and layer


def test_every_cell_resolves_to_its_files():
    used_configs = set()
    for w in SPEC["workloads"]:
        cell = Cell(w["name"], SPEC)
        used_configs.add(w["config"])
        assert config_path(SPEC, w["config"]).is_file()
        assert traffic_path(w["traffic"]).is_file()
        assert generator_path(cell.traffic["generator"]).is_file()
        assert driver_path(cell.traffic["driver"]).is_file()
        assert limits_path(w["name"]).is_file() and cell.limits
        assert all(isinstance(v, (int, float)) for v in cell.limits.values())
        if cell.driver().KIND == "localize":
            fitter = ref_locs.fitter(cell.config["fit"])
            assert callable(fitter.fit) and fitter.LOCS_DTYPE.names
        for m in cell.per_layer:
            assert metric_path(m["name"]).is_file()
            assert hasattr(load_module(metric_path(m["name"]), "m"), "read")
    assert used_configs == {c["name"] for c in SPEC["configs"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    assert {p.stem for p in (BENCH / "limits").glob("*.json")} <= cells


def test_a_reference_fit_is_found_by_the_fitters_name():
    fit = {"fitting_method": "gaussmle", "mle_method": "sigmaxy"}
    assert ref_locs.fitter_name(fit) == "gaussmle.sigmaxy"
    assert ref_locs.fitter(fit).LOCS_DTYPE == ref_locs.LOCS_DTYPE
    assert ref_locs.fitter_name({"fitting_method": "gausslq"}) == "gausslq"
    with pytest.raises(FileNotFoundError, match="no reference fit"):
        ref_locs.fitter({"fitting_method": "gaussmle", "mle_method": "x"})


def test_per_layer_metrics_list_cells_that_report_what_they_move():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    perf_md = (ROOT / "PERF.md").read_text()
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        assert m["layer"] in perf_md
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_roofline_counts_at_boxes_7_and_17():
    from roofline import fit, identify, peaks

    assert fit.mle_flops_per_spot_iter(7) == 2341
    assert fit.mle_flops_per_spot_iter(17) == 10441
    f, b = identify.work(7, 256, 256, 256, 0)
    assert f == 256 * 249 * 249 * 14 and b == 256 * 256 * 256 * 2
    t, what = peaks.bound_s(f, b)
    assert what == "bytes" and t == pytest.approx(b / 3.35e12)
    # a fit of 131,072 spots of 10 steps: 11 passes of 2341 operations
    ops, nbytes = fit.work(7, 131072, 10.0)
    assert ops == 131072 * 11 * 2341
    assert peaks.bound_s(ops, nbytes)[1] == "operations"


def _canned_trace():
    """A traced window of 10 s: identify 1 s, the fit 2 s (half of it
    over identify's), a copy 1 s alone."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "ts": 0, "dur": 10e6},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 5e6,
         "dur": 3e6},
        {"ph": "X", "cat": "kernel", "name":
         "void (anonymous namespace)::identify_kernel<7, unsigned short>()",
         "ts": 1e6, "dur": 1e6},
        {"ph": "X", "cat": "kernel", "name":
         "void (anonymous namespace)::mle_queue_kernel<7>()",
         "ts": 1.5e6, "dur": 2e6},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 8.5e6, "dur": 1e6},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 0},
    ]
    return trace_mod.from_chrome(ev)


def _record(trace):
    cfg = json.loads((BENCH / "configs" / "dnapaint2d-b7-mle.json")
                     .read_text())
    calls = [{"host_s": 2.0, "work": 1000, "frames": 256, "height": 256,
              "width": 256, "perf": {"total_s": 1.25, "upload_dispatch_s":
                                     0.5, "drain_s": 0.25}},
             {"host_s": 3.0, "work": 3000, "frames": 256, "height": 256,
              "width": 256, "perf": {"total_s": 2.25, "upload_dispatch_s":
                                     0.75, "drain_s": 0.5}}]
    return {"trace": trace, "config": cfg, "calls": calls,
            "reference": {"mean_iterations": 9.0}}


def _read(name, record):
    return load_module(metric_path(name), "m_" + name.replace(".", "_")) \
        .read(record)


def test_metric_readers_on_a_canned_trace_and_record():
    from roofline import fit, identify

    tr = _canned_trace()
    assert tr.window == (0.0, 10.0)
    assert trace_mod.busy_s(tr) == pytest.approx(3.5)
    rec = _record(tr)
    assert _read("localize.after_chunks_s", rec) == pytest.approx(0.75)
    assert _read("stream.upload_s", rec) == pytest.approx(0.625)
    assert _read("fused.drain_s", rec) == pytest.approx(0.375)
    assert _read("device_idle_pct.localize", rec) == pytest.approx(65.0)
    assert _read("device_idle_pct.undrift", rec) == pytest.approx(65.0)
    assert _read("identify.roofline_pct", rec) == pytest.approx(
        100 * identify.least_s(7, rec["calls"]) / 1.0)
    assert _read("fit.roofline_pct", rec) == pytest.approx(
        100 * fit.least_s(7, 4000, 9.0) / 2.0)
    gaps = trace_mod.breakdown(tr)
    assert gaps["device_ops"][0] == [
        "void (anonymous namespace)::mle_queue_kernel<7>()",
        pytest.approx(2.0)]
    # the longest gap, 3.5 .. 8.5 s, named by the host op at its middle
    assert gaps["idle_gaps"][0] == ["aten::copy_", pytest.approx(5.0)]


def test_readers_return_nothing_without_something_to_read():
    rec = _record(None)
    for name in ("identify.roofline_pct", "fit.roofline_pct",
                 "device_idle_pct.localize"):
        assert _read(name, rec) is None
    rec = _record(trace_mod.from_chrome([
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "ts": 0, "dur": 1e6}]))
    assert _read("identify.roofline_pct", rec) is None
    assert _read("device_idle_pct.localize", rec) is None
    rec["calls"] = [{"host_s": 1.0, "perf": None}]
    assert _read("localize.after_chunks_s", rec) is None


def test_forbidden_modules_compare_whole_top_level_names():
    found = dev_info.forbidden_modules(
        ["picasso_torch", "picasso_torch.ops", "jax.numpy", "jaxlib",
         "picasso_tpu.io", "flax", "jaxtyping", "picasso_tpux"])
    assert found == ["flax", "jax.numpy", "jaxlib", "picasso_tpu.io"]


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_run_without_a_card_fails_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(["benchmark/run.py", "--workload", "2d-b7-mle-dense",
                "--seed", str(2 ** 33), "--seconds", "1", "--trace", "0"],
               ROOT, env)
    assert out.returncode != 0
    assert "correct" not in out.stdout
    assert "no result" in out.stderr


def test_run_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(["benchmark/run.py", "--workload", "2d-b7-mle-dense",
                "--seed", "1", "--seconds", "1", "--trace", "0"], tmp_path)
    assert out.returncode != 0
    assert "correct" not in out.stdout
