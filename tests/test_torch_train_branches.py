"""``chip_smoke.py`` phase 10 (b)'s ReLU branch rule, on the CPU.

The phase holds one ACV step on the card against the same step on the CPU
(B=2, 32×64, max_disp 64).  A ReLU input within rounding of zero takes its
branch by rounding, and the CPU's float32 rounding depends on the host's
instruction set (oneDNN picks its kernels by it), so the CPU step takes the
card's branch where the two inputs lie at most ``BRANCH_GAP`` of the site's
RMS apart (``ReluBranches``).  Here a subprocess with oneDNN held to AVX2
stands in for the card, and the step in this process is aligned to it:
the float32 step then meets phase 10 (b)'s tolerances.  A record whose
sign differs by more than the gap fails the alignment.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import pytest
import torch

import chip_smoke as cs

ROOT = pathlib.Path(__file__).resolve().parents[1]

RECORD = """
import sys, torch
torch.set_num_threads(1)
import chip_smoke as cs
run = cs.train_step_run("cpu", torch.float32)
torch.save({"loss": run["loss"], "grads": run["grads"], "params": run["params"],
            "stats": run["stats"], "seen": run["branches"].seen}, sys.argv[1])
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one intra-op thread, as the training parity files run it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def avx2_step(tmp_path_factory):
    """The float32 step recorded in a process whose oneDNN runs AVX2 code."""
    path = tmp_path_factory.mktemp("branches") / "avx2.pt"
    env = dict(os.environ, ONEDNN_MAX_CPU_ISA="AVX2")
    subprocess.run([sys.executable, "-c", RECORD, str(path)], cwd=ROOT, env=env,
                   check=True, timeout=600)
    return torch.load(path)


def test_cpu_step_aligned_to_another_instruction_set_meets_the_tolerances(avx2_step):
    card = dict(avx2_step)
    cpu = cs.train_step_run("cpu", torch.float32, card.pop("seen"))
    worst = cs.train_step_gaps(card, cpu)
    tol = cs.TRAIN_TOL["float32"]
    assert all(worst[k] <= tol[k] for k in tol), worst
    assert len(worst["branch_flips"]) <= cs.BRANCH_SHARE * worst["relu_inputs"]
    assert all(f["gap_over_rms"] <= cs.BRANCH_GAP for f in worst["branch_flips"])


def test_a_flip_beyond_rounding_fails(avx2_step):
    """The largest input of a decoder sum in the record given the other
    sign: the aligned step refuses it."""
    seen = list(avx2_step["seen"])
    k = next(i for i, (name, _) in enumerate(seen) if name.endswith("conv5+redir2"))
    name, ref = seen[k]
    ref = ref.clone()
    ix = tuple(int(i) for i in torch.unravel_index(ref.abs().argmax(), ref.shape))
    ref[ix] = -ref[ix]
    seen[k] = (name, ref)
    with pytest.raises(AssertionError, match="RMS apart"):
        cs.train_step_run("cpu", torch.float32, seen)
