"""The program's spans in a trace (``benchmark/spans.py``) and the readers
of the metrics made from them, on hand-built Chrome traces: nested
``user_annotation`` spans, launches and their device operations, a launch
from a second thread inside a span, a launch outside every span, an
operation with no launch, and idle gaps between them."""

import json

import pytest

from benchmark import harness, peaks, run, spans, tracing


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _launch(corr, ts, tid=1, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 3, "tid": tid,
            "args": {"correlation": corr}}


def _op(corr, ts, dur, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


# One evaluation call (times in µs): the prep with the feature trunk and a
# copy, one DDIM step with a copy and a launch from another thread.
EVAL = [
    _span("dv.infer", 0, 1000),
    _span("dv.prep", 10, 300),
    _span("dv.features", 20, 100),
    _launch(1, 30), _op(1, 40, 50),                                       # busy 40-90
    _span("dv.h2d", 200, 50),
    {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 205, "dur": 40},
    _launch(2, 210, name="cudaMemcpyAsync"), _op(2, 240, 10, "gpu_memcpy"),  # gap 150
    _span("dv.ddim.step", 400, 300),
    _launch(3, 410), _op(3, 420, 100),                                    # gap 170
    _span("dv.h2d", 500, 20),
    _launch(4, 505, name="cudaMemcpyAsync"), _op(4, 530, 5, "gpu_memcpy"),   # gap 10
    _launch(5, 600, tid=2), _op(5, 610, 30),                              # gap 75
    _launch(6, 1100), _op(6, 1110, 10),                                   # gap 470, no span
    _op(7, 1200, 5),                                                      # gap 80, no launch
]

# One training step: the forward with a copy, the backward launched from
# autograd's thread, the optimiser.
TRAIN = [
    _span("dv.train.forward", 0, 100),
    _launch(1, 10), _op(1, 20, 30),                                       # busy 20-50
    _span("dv.h2d", 40, 20),
    _launch(2, 45, name="cudaMemcpyAsync"), _op(2, 70, 5, "gpu_memcpy"),  # gap 20
    _span("dv.train.backward", 100, 200),
    _launch(3, 150, tid=2), _op(3, 160, 100),                             # gap 85
    _span("dv.train.optimizer", 300, 100),
    _launch(4, 310), _op(4, 320, 20),                                     # gap 60
]

NEW = {"eval": ["prep_device_ms_per_pair", "ddim_step_device_ms", "trunk2d_device_ms_per_pair",
                "issue_ms_per_pair", "h2d_copies.infer", "h2d_idle_ms.infer"],
       "train": ["forward_device_ms_per_step", "backward_device_ms_per_step",
                 "optimizer_device_ms_per_step", "h2d_copies.train", "h2d_idle_ms.train"]}


def test_bench_span_reduction():
    r = spans.reduce(EVAL)
    assert r["ops"] == 7 and r["first_s"] == pytest.approx(40e-6)
    want_device = {spans.INFER: 195, spans.PREP: 60, spans.FEATURES: 50, spans.H2D: 15,
                   spans.DDIM_STEP: 135, spans.REFINE: 0}
    for name, us in want_device.items():
        assert spans.device_s(r, name) == pytest.approx(us * 1e-6), name
    assert spans.device_s(r, spans.FEATURES, spans.REFINE) == pytest.approx(50e-6)
    assert sum(r["device"].values()) == pytest.approx(210e-6)
    for name, us, n in ((spans.INFER, 1000, 1), (spans.PREP, 300, 1), (spans.FEATURES, 100, 1),
                        (spans.H2D, 70, 2), (spans.DDIM_STEP, 300, 1)):
        assert spans.host_s(r, name) == pytest.approx(us * 1e-6), name
        assert spans.count(r, name) == n
    assert spans.host_s(r, spans.H2D, inside=spans.DDIM_STEP) == pytest.approx(20e-6)
    assert r["idle"] == pytest.approx({spans.H2D: 160e-6, spans.DDIM_STEP: 245e-6,
                                       spans.OUTSIDE: 470e-6, spans.UNATTRIBUTED: 80e-6})
    # The same gaps as tracing.reduce's, put down otherwise.
    assert sum(r["idle"].values()) == pytest.approx(sum(tracing.reduce(EVAL)["gaps"].values()))

    t = spans.reduce(TRAIN)
    for name, us in ((spans.TRAIN_FORWARD, 35), (spans.TRAIN_BACKWARD, 100),
                     (spans.TRAIN_OPTIMIZER, 20), (spans.H2D, 5)):
        assert spans.device_s(t, name) == pytest.approx(us * 1e-6), name
    assert t["idle"] == pytest.approx({spans.H2D: 20e-6, spans.TRAIN_BACKWARD: 85e-6,
                                       spans.TRAIN_OPTIMIZER: 60e-6})


def _ctx(events, phase, path, monkeypatch, **units):
    path.write_text(json.dumps({"traceEvents": events}))
    monkeypatch.setattr(run, "TRACE_FILE", path)
    red = tracing.read(path)
    return {"phase": phase, "window_s": 2e-3, "busy_s": red["busy_s"], "ops": red["ops"],
            "kernels": red["kernels"], "work": {"flops": 0.0, "conv3d": []},
            "peaks": peaks.PEAKS["NVIDIA H100 80GB HBM3"], "peak_dtype": "bfloat16",
            "group_of": peaks.group_of, **units}


def _read(ctx):
    return {m: harness.reader(m)(ctx) for m in NEW["eval"] + NEW["train"]}


def test_bench_span_readers(tmp_path, monkeypatch):
    ctx = _ctx(EVAL, "eval", tmp_path / "eval.json", monkeypatch, pairs=2, calls=1, steps=0)
    got = _read(ctx)
    want = {"prep_device_ms_per_pair": 0.030, "ddim_step_device_ms": 0.0675,
            "trunk2d_device_ms_per_pair": 0.025, "issue_ms_per_pair": 0.465,
            "h2d_copies.infer": 1.0, "h2d_idle_ms.infer": 0.080}
    assert {m: got[m] for m in NEW["eval"]} == pytest.approx(want)
    assert all(got[m] is None for m in NEW["train"])

    ctx = _ctx(TRAIN, "train", tmp_path / "train.json", monkeypatch, steps=1, calls=1)
    got = _read(ctx)
    want = {"forward_device_ms_per_step": 0.035, "backward_device_ms_per_step": 0.100,
            "optimizer_device_ms_per_step": 0.020, "h2d_copies.train": 1.0,
            "h2d_idle_ms.train": 0.020}
    assert {m: got[m] for m in NEW["train"]} == pytest.approx(want)
    assert all(got[m] is None for m in NEW["eval"])


def test_bench_span_readers_need_the_ctx_trace(tmp_path, monkeypatch):
    """None where the file is not the trace ``ctx`` came from (another count
    of operations, another first start), where there is no file, where
    nothing ran, and where the program emitted no span (as its parent)."""
    ctx = _ctx(EVAL, "eval", tmp_path / "eval.json", monkeypatch, pairs=2, calls=1, steps=0)
    for other in (dict(ctx, ops=ctx["ops"][1:]),
                  dict(ctx, ops=[(n, ts + 1e-6, d) for n, ts, d in ctx["ops"]]),
                  dict(ctx, busy_s=0.0)):
        assert all(v is None for v in _read(other).values())
    monkeypatch.setattr(run, "TRACE_FILE", tmp_path / "missing.json")
    assert all(v is None for v in _read(ctx).values())
    bare = [e for e in EVAL if e["cat"] != "user_annotation"]
    ctx = _ctx(bare, "eval", tmp_path / "bare.json", monkeypatch, pairs=2, calls=1, steps=0)
    assert all(v is None for v in _read(ctx).values())


def test_bench_span_names_from_program():
    from diffuvolume_tpu_torch.utils import spans as program

    assert spans.PREFIX == program.PREFIX
    assert spans.NAMES == tuple(program.PREFIX + n for n in program.NAMES)


def test_bench_span_metrics_declared():
    declared = {m["name"]: m for m in harness.load_spec()["per_layer"]}
    for phase, names in NEW.items():
        for name in names:
            m = declared[name]
            assert m["source"] == "device_trace" and m["better"] == "lower"
            assert m["moves"] == ("pairs_per_s" if phase == "eval" else "train_step_ms")
