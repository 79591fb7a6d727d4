"""The two scaling tools, ``tools/scaling_model.py`` and
``tools/scaling_bench.py``, on the CPU.

* ``scaling_model``: its all-reduce bytes are the trainable parameters'
  count × 4 (float32), its FLOPs a positive count of one step, and its
  projection (ring all-reduce ``2·(N − 1)/N`` of the payload, the overlapped
  and serial efficiencies) holds on given numbers;
* ``scaling_bench --device cpu --devices 2`` at a tiny size (gloo ranks)
  prints a finite efficiency with the JAX tool's fields; more ranks than
  the machine has cards raises.
"""

import json
import math

import pytest
import torch

from diffuvolume_tpu_torch.models import build_model
from diffuvolume_tpu_torch.tools import scaling_bench, scaling_model
from diffuvolume_tpu_torch.tools.flops import count_params

JAX_FIELDS = ("metric", "devices", "tput_1", "tput_N", "value", "unit")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_scaling_model_bytes_and_flops(capsys):
    rec = scaling_model.main(["--step-ms", "100", "--devices", "4", "--hw", "32", "64",
                              "--per_device_batch", "1", "--maxdisp", "64"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    model = build_model("acvnet_ddim", max_disp=64)
    assert rec["params"] == count_params(model)
    assert rec["allreduce_bytes_per_step"] == 4 * count_params(model)
    assert rec["flops_per_device_step"] > 0
    assert rec["assumptions"]["link_bytes_per_s"] == 450e9


@pytest.mark.parametrize("step_ms, overlapped, serial", [(10.0, 1.0, 10.0 / 16.0),
                                                         (3.0, 0.5, 3.0 / 9.0)])
def test_scaling_model_projection(step_ms, overlapped, serial):
    """1e6 parameters over 4 devices at 1 GB/s: 4 MB, each device moving
    1.5 × 4 MB, 6 ms."""
    out = scaling_model.project(10**6, step_ms, 4, 1e9)
    assert out["allreduce_bytes_per_step"] == 4 * 10**6
    assert math.isclose(out["t_comm_ms"], 6.0)
    assert math.isclose(out["projected_efficiency_overlapped"], overlapped)
    assert math.isclose(out["projected_efficiency_serial"], serial)


def test_scaling_bench_on_cpu_ranks(capsys):
    rec = scaling_bench.main(["--device", "cpu", "--devices", "2", "--hw", "32", "64",
                              "--maxdisp", "64", "--iters", "1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert all(k in rec for k in JAX_FIELDS)
    assert rec["metric"] == "dp_scaling_efficiency" and rec["devices"] == 2
    assert rec["unit"] == "fraction" and rec["backend"] == "gloo" and rec["device"] == "cpu"
    assert all(math.isfinite(rec[k]) and rec[k] > 0 for k in ("tput_1", "tput_N", "value"))


def test_scaling_bench_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="1 cards"):
        scaling_bench.main(["--devices", "2"])
