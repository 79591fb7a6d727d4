"""The measuring tools: ``tools/flops.py``, ``tools/profiling.py`` and
``tools/bench_train.py``, on the CPU.

* ``count_params`` of a port ACVNet equals the JAX package's
  ``count_params`` of the same weights carried over by its converter (and
  ``trainable_param_report``'s total);
* ``flop_count`` of one 3×3×3 conv, one matmul and one transposed conv is
  the analytic ``2·MACs``; a kernel launch during a count raises;
* ``speed_of_light`` raises on a card without published peaks, and on the
  H100 gives the bound of the dtype's rate and the memory rate, with the
  card and power limit;
* ``time_stage`` and ``bench_train`` need a card and say so;
  ``bench_train``'s step runs on the CPU at a small size with a finite
  loss, and its ``--ddp`` step in a gloo group of one gives the plain
  step's loss within 1e-5 relative.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from diffuvolume_tpu.tools.flops import count_params as j_count_params
from diffuvolume_tpu.tools.flops import trainable_param_report as j_report
from diffuvolume_tpu_torch.ops.kernels import gwc_volume as kg
from diffuvolume_tpu_torch.tools import bench_train, profiling
from diffuvolume_tpu_torch.tools.flops import count_params, flop_count, trainable_param_report
from diffuvolume_tpu_torch.tools.random_weights import random_acv
from torch_parity import to_jax_variables


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("diffusion", [True, False])
def test_count_params_matches_jax(diffusion):
    model = random_acv(64, diffusion, torch.Generator().manual_seed(0))
    variables = to_jax_variables(model)
    assert count_params(model) == j_count_params(variables["params"])
    report = trainable_param_report(model)
    assert math.isclose(report["TOTAL_M"], j_report(variables)["TOTAL_M"], rel_tol=1e-12)
    assert math.isclose(sum(v for k, v in report.items() if k != "TOTAL_M"),
                        report["TOTAL_M"], rel_tol=1e-12)


def test_flop_count_is_two_macs():
    x, w = torch.randn(2, 4, 6, 7, 8), torch.randn(5, 4, 3, 3, 3)
    conv = flop_count(F.conv3d, x, w, padding=1)
    assert conv["flops"] == 2 * (2 * 5 * 6 * 7 * 8) * (4 * 27)
    a, b = torch.randn(3, 4), torch.randn(4, 5)
    assert flop_count(torch.matmul, a, b)["flops"] == 2 * 3 * 4 * 5
    up = flop_count(F.conv_transpose3d, torch.randn(1, 4, 3, 3, 3), torch.randn(4, 6, 4, 4, 4),
                    stride=2, padding=1)
    assert up["flops"] == 2 * (4 * 27) * (6 * 64)
    assert "elementwise" in conv["counted"]


def test_flop_count_refuses_kernel_launches():
    def launches():
        kg.gwc_volume.launches += 1

    saved = kg.gwc_volume.launches
    try:
        with pytest.raises(RuntimeError, match="gwc_volume"):
            flop_count(launches)
    finally:
        kg.gwc_volume.launches = saved


def test_speed_of_light():
    with pytest.raises(KeyError, match="no published peaks"):
        profiling.StageReport("x", 1.0, flops=1e9).speed_of_light("NVIDIA GeForce GTX 1080")
    sol = profiling.StageReport("conv", 2.0, flops=989e9, bytes_moved=3.35e9,
                                dtype="bfloat16").speed_of_light("NVIDIA H100 80GB HBM3")
    assert sol["power_limit_w"] == 700.0 and "H100" in sol["card"]
    assert math.isclose(sol["flops_sol_ms"], 1.0) and math.isclose(sol["bw_sol_ms"], 1.0)
    assert math.isclose(sol["bw_efficiency"], 0.5) and sol["bound_ms"] == 1.0
    f32 = profiling.StageReport("conv", 2.0, flops=67e9).speed_of_light("NVIDIA H100 80GB HBM3")
    assert math.isclose(f32["flops_sol_ms"], 1.0) and f32["bound_by"] == "operations"


def test_kernel_groups():
    assert profiling.group_of("void conv_s1<128, 4, true, 1, false>(...)").startswith("port: 3-D")
    assert profiling.group_of("cudnn::bn_bw_1C11_kernel_new") == "batch norm"
    assert profiling.group_of("void at::native::multi_tensor_apply_kernel<Adam>") == (
        "optimizer (Adam, clip)")


def test_card_only_tools_refuse_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.time_stage(lambda: None)
    with pytest.raises(SystemExit):
        bench_train.main(["--steps", "1"])


def test_bench_train_step_on_the_cpu():
    """The benchmark's step at 32×64, batch 2: two steps, finite losses."""
    args = bench_train.parse_args(["--batch", "2", "--height", "32", "--width", "64"])
    step = bench_train.make_step(args, torch.device("cpu"))
    losses = [float(step()) for _ in range(2)]
    assert all(math.isfinite(v) for v in losses) and losses[0] != losses[1]


def test_bench_train_ddp_step_on_the_cpu():
    """``--ddp``'s step in a gloo group of one process at 32×64, batch 2:
    its loss equals the plain step's within 1e-5 relative (the global
    BatchNorm's own float32 summation order), both finite."""
    from diffuvolume_tpu_torch.parallel import ddp

    args = bench_train.parse_args(["--batch", "2", "--height", "32", "--width", "64", "--ddp"])
    plain = float(bench_train.make_step(args, torch.device("cpu"))())
    dp = ddp.init(0, 1, "cpu", f"tcp://localhost:{ddp.free_port()}")
    try:
        loss = float(bench_train.make_step(args, torch.device("cpu"), dp)())
    finally:
        ddp.shutdown()
    assert math.isfinite(loss) and abs(loss / plain - 1) < 1e-5
