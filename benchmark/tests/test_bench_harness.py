"""The harness on the CPU: ``BENCHMARK.json`` against the contract it is
written to, the files it names, the result line, the metric readers, the
trace reduction, and the modules the benchmark may not import."""

import ast
import json
import re
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import harness, peaks, tracing

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_bench_spec_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    cells = len(SPEC["workloads"])
    # A full check with 24 cells fits the driver's 43200 s.
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(SPEC["configs"]) <= 24
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, cells // 4)
    assert len(json.dumps(SPEC)) <= 64 * 1024
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    for word in SPEC["command"]:
        assert 1 <= len(word) <= 200 and ".." not in word and not word.startswith("/")


def test_bench_names_and_units():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"]] + CELLS
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        allowed = {"name", "unit", "better", "source", "workloads"}
        if m in SPEC["end_to_end"]:
            allowed.add("bound")
            assert m["source"] in ("host_clock", "device_trace")
            assert 0 < m["bound"] <= 0.25
        else:
            allowed |= {"layer", "moves"}
            assert 1 <= len(m["layer"]) <= 200 and "\t" not in m["layer"]
        assert set(m) <= allowed
    for text in [w["why"] for w in SPEC["workloads"]] + [c["why"] for c in SPEC["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in SPEC["end_to_end"])


def test_bench_files_found_by_name():
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert harness.family(json.loads((ROOT / c["file"]).read_text()))
    for name in CELLS:
        cell = harness.cell(SPEC, name)
        assert harness.driver(cell["traffic"])
        assert cell["traffic"]["phase"] in cell["cfg"]["limits"]
    for m in SPEC["per_layer"]:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("name", CELLS)
def test_bench_every_cell_reports_its_metrics(name):
    """``setup_s`` and another end-to-end metric, a per-layer metric, and
    for each per-layer metric the end-to-end metric it moves."""
    cell = harness.cell(SPEC, name)
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in e2e, (m["name"], m["moves"])


def test_bench_layers_named_alike():
    by_layer = {}
    for m in SPEC["per_layer"]:
        by_layer.setdefault(m["layer"], []).append(m["name"])
    assert by_layer["device (H100)"] == ["idle_share.infer", "idle_share.train"]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                out.add(arg.value.split(".")[0])
    return out


def test_bench_imports_no_jax():
    """No module of the benchmark has ``jax``, ``jaxlib``, ``flax`` or
    ``diffuvolume_tpu`` as its top-level name (compared whole: the
    program's name begins with the last); the reference none of the
    program's either."""
    for path in BENCH.rglob("*.py"):
        names = _imports(path)
        assert not names & set(harness.BANNED), (path, names)
        if "reference" in path.parts:
            assert "diffuvolume_tpu_torch" not in names, path
    assert "diffuvolume_tpu_torch".split(".")[0] not in harness.BANNED


def test_bench_banned_modules_compared_whole(monkeypatch):
    import sys

    import diffuvolume_tpu_torch  # noqa: F401

    assert "diffuvolume_tpu" not in sys.modules
    assert "diffuvolume_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", SimpleNamespace())
    assert "jax" in harness.banned_modules()


EVENTS = [
    {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0, "dur": 50},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 5,
     "args": {"correlation": 1}},
    {"ph": "X", "cat": "kernel", "name": "conv_s1<a, false>", "ts": 20, "dur": 30,
     "args": {"correlation": 1}},
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 60, "dur": 40},
    {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 70, "dur": 10},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 75, "dur": 5,
     "args": {"correlation": 2}},
    {"ph": "X", "cat": "kernel", "name": "cudnn_fprop", "ts": 90, "dur": 10,
     "args": {"correlation": 2}},
    {"ph": "X", "cat": "kernel", "name": "elementwise_kernel", "ts": 95, "dur": 10,
     "args": {"correlation": 3}},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 200, "dur": 10},
]


def test_bench_trace_reduction():
    r = tracing.reduce(EVENTS)
    assert r["kernels"] == 3
    assert r["busy_s"] == pytest.approx(55e-6)
    assert r["gaps"] == pytest.approx({"aten::copy_": 40e-6, "unattributed": 95e-6})


def _fake_res(phase):
    units = {"pairs": 4, "calls": 1} if phase == "eval" else {"steps": 1, "calls": 1}
    return {"setup_end": 100.0, "e2e": {"pairs_per_s": 5.0, "pair_ms_p95": 200.0,
                                        "train_step_ms": 300.0},
            "attempted": 40, "failed": 0, "memory_peak_bytes": 1 << 30,
            "checks": {"base_mean_px": 0.1, "final_mean_px": 0.2, "base_mean_ratio": 1.0,
                       "final_median_ratio": 1.0, "final_mean_ratio": 1.0, "loss_gap": 0.0,
                       "grad_gap": 0.0, "grad_gap_median": 0.0, "pred_gap_first": 0.0,
                       "change_gap": 0.0},
            "slice": SimpleNamespace(window_s=250e-6), "units": units,
            "count": lambda: {"flops": 1e6, "conv3d": [(2e6, 4e3)]}}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_bench_result_line(name, trace, tmp_path):
    from benchmark import run

    cell = harness.cell(SPEC, name)
    trace_file = None
    if trace:
        trace_file = tmp_path / "trace.json"
        trace_file.write_text(json.dumps({"traceEvents": EVENTS}))
    line, err = run.result(cell, _fake_res(cell["traffic"]["phase"]), 90.0,
                           "NVIDIA H100 80GB HBM3", trace_file)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    want = cell["per_layer"] if trace else cell["end_to_end"]
    if trace:
        assert line["device"]["busy_s"] > 0 and set(line["breakdown"]) == {"device_ops",
                                                                           "idle_gaps"}
        assert set(line["metrics"]) <= {m["name"] for m in want}
    else:
        assert set(line["metrics"]) == {m["name"] for m in want}
        assert line["metrics"]["setup_s"]["value"] == pytest.approx(10.0)
    for k, c in line["checks"].items():
        assert err[-len(line["checks"]):][list(line["checks"]).index(k)].startswith(f"check {k}")
    json.dumps(line)


def test_bench_readers_leave_out_what_they_cannot_read():
    ctx = {"phase": "eval", "pairs": 4, "steps": 0, "calls": 1, "window_s": 1.0,
           "busy_s": 0.0, "ops": [], "kernels": 0, "work": {"flops": 0.0, "conv3d": []},
           "peaks": peaks.PEAKS["NVIDIA H100 80GB HBM3"], "peak_dtype": "bfloat16",
           "group_of": peaks.group_of}
    for m in SPEC["per_layer"]:
        assert harness.reader(m["name"])(ctx) is None, m["name"]


def test_bench_groups_frozen_from_program():
    from diffuvolume_tpu_torch.tools import profiling

    assert peaks.GROUPS == profiling.GROUPS
    assert peaks.PEAKS["NVIDIA H100 80GB HBM3"]["flops"] == \
        profiling.PEAKS["NVIDIA H100 80GB HBM3"]["flops"]
