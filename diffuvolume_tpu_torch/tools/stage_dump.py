"""Where the ACV folded path's card-vs-CPU gap enters, stage by stage.

    python -m diffuvolume_tpu_torch.tools.stage_dump [--out chiprun_out/stage_dump.json]

Runs the folded ACV baseline forward and one DDIM aggregation at 32×64,
max_disp 64, float32 (``float32_exact``: no TF32), with the weights and
images of ``chip_smoke.py``'s phase 4 (seed 0, heads calibrated to logit std
10), once on the card and once on the CPU (the kernels' plain versions), and
compares every stage: the 2-D trunk's features, the GWC volume in its slot
(row 16), the two patch stencils (row 10), the attention chain's convs and
its logits, the concat features and the softmaxed attention, the concat
volume × attention (row 3), each aggregation stage and hourglass, the cost,
and row 1's disparity and uncertainty; then the DDIM model's volume × a
fixed noise map (row 4) and its aggregation.

Each stage is compared twice: ``propagated``, the card's chain against the
CPU's chain (what the output sees), and ``local``, the stage alone on the
card fed the CPU's inputs (what the stage itself adds).  Then ``from``: the
card's chain started from the CPU's values at a stage (the trunk, the
attention logits, the concat volume, the aggregation's last conv), and the
disparities' max |card − CPU| at its end: how much of the output's gap
enters before that stage.  ``max_abs`` is
max |card − CPU|; ``max_rel`` is max |card − CPU| / (|CPU| + 1e-3·max |CPU|)
over the tensor.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess

import numpy as np
import torch

from diffuvolume_tpu_torch.eval.pipeline import float32_exact
from diffuvolume_tpu_torch.models.acv_fold import fold_acv, hourglass_folded
from diffuvolume_tpu_torch.ops.kernels.concat_volume import concat_volume, dhw_mul
from diffuvolume_tpu_torch.ops.kernels.conv3d_fold import conv3d_fold_p, conv3d_fold_x2
from diffuvolume_tpu_torch.ops.kernels.depthwise import depthwise_hw_p
from diffuvolume_tpu_torch.ops.kernels.fused_head import fused_upsample_softargmin
from diffuvolume_tpu_torch.ops.kernels.gwc_volume import gwc_volume_packed
from diffuvolume_tpu_torch.tools.random_weights import calibrate_heads, random_pair
from diffuvolume_tpu_torch.utils.device import resolve_device

H, W, MAX_DISP = 32, 64, 64


def stage_list(fb, fd):
    """``(name, input names, fn)`` in order; ``fb`` / ``fd`` are the folded
    baseline and DDIM models."""
    m, d = fb.model, MAX_DISP // 4

    def aggregation(prefix, fold, vol):
        return [
            (f"{prefix}dres0_0", (vol,), lambda v: conv3d_fold_x2(v, *fold.dres0_0, act="relu")),
            (f"{prefix}dres0_1", (f"{prefix}dres0_0",),
             lambda v: conv3d_fold_p(v, *fold.dres0_1, act="relu")),
            (f"{prefix}dres1_0", (f"{prefix}dres0_1",),
             lambda v: conv3d_fold_p(v, *fold.dres1_0, act="relu")),
            (f"{prefix}dres1_1 + residual", (f"{prefix}dres1_0", f"{prefix}dres0_1"),
             lambda v, r: conv3d_fold_p(v, *fold.dres1_1, residual=r)),
            (f"{prefix}hourglass dres2", (f"{prefix}dres1_1 + residual",),
             lambda v: hourglass_folded(fold.dres2, v)),
            (f"{prefix}hourglass dres3", (f"{prefix}hourglass dres2",),
             lambda v: hourglass_folded(fold.dres3, v)),
            (f"{prefix}classif2_0", (f"{prefix}hourglass dres3",),
             lambda v: conv3d_fold_p(v, *fold.classif2_0, act="relu")),
            (f"{prefix}cost", (f"{prefix}classif2_0",),
             lambda v: conv3d_fold_p(v, *fold.classif2_1)[..., 0].float().contiguous()),
            (f"{prefix}disparity (row 1)", (f"{prefix}cost",),
             lambda c: fused_upsample_softargmin(c, MAX_DISP, (H, W))[0]),
            (f"{prefix}uncertainty (row 1)", (f"{prefix}cost",),
             lambda c: fused_upsample_softargmin(c, MAX_DISP, (H, W))[1]),
        ]

    return [
        ("trunk left", ("left", "right"), lambda lt, rt: m.trunk(lt, rt)[0]),
        ("trunk right", ("left", "right"), lambda lt, rt: m.trunk(lt, rt)[1]),
        ("gwc volume in slot (row 16)", ("trunk left", "trunk right"),
         lambda fl, fr: gwc_volume_packed(fl, fr, d, m.num_groups, fb.att_slot)),
        ("patch stencil 1 (row 10)", ("gwc volume in slot (row 16)",),
         lambda v: depthwise_hw_p(v, *fb.patch)),
        ("patch stencil 2 (row 10)", ("patch stencil 1 (row 10)",),
         lambda v: depthwise_hw_p(v, *fb.patch_l123)),
        ("attention dres1_att_0", ("patch stencil 2 (row 10)",),
         lambda v: conv3d_fold_x2(v, *fb.dres1_att_0, act="relu")),
        ("attention dres1_att_1", ("attention dres1_att_0",),
         lambda v: conv3d_fold_p(v, *fb.dres1_att_1)),
        ("attention hourglass", ("attention dres1_att_1",),
         lambda v: hourglass_folded(fb.dres2_att_, v)),
        ("attention classif_att_0", ("attention hourglass",),
         lambda v: conv3d_fold_p(v, *fb.classif_att_0, act="relu")),
        ("attention logits", ("attention classif_att_0",),
         lambda v: conv3d_fold_p(v, *fb.classif_att_1)[..., 0]),
        ("concat features left", ("trunk left",), lambda f: m.concatconv(f).contiguous()),
        ("concat features right", ("trunk right",), lambda f: m.concatconv(f).contiguous()),
        ("attention softmax", ("attention logits",),
         lambda a: torch.softmax(a.float(), dim=1).contiguous()),
        ("concat volume × attention (row 3)",
         ("concat features left", "concat features right", "attention softmax"),
         lambda cl, cr, a: concat_volume(cl, cr, d, att=a, channels_last=True)),
        *aggregation("", fb, "concat volume × attention (row 3)"),
        ("DDIM concat volume (row 3)", ("concat features left", "concat features right"),
         lambda cl, cr: concat_volume(cl, cr, d, channels_last=True)),
        ("DDIM volume × attention × noise (row 4)",
         ("DDIM concat volume (row 3)", "attention softmax", "noise"),
         lambda v, a, n: dhw_mul(v, a, n, channels_last=True)),
        *aggregation("DDIM ", fd, "DDIM volume × attention × noise (row 4)"),
    ]


def compare(card: torch.Tensor, cpu: torch.Tensor) -> dict:
    card, cpu = card.float().cpu(), cpu.float()
    err = (card - cpu).abs()
    ref = cpu.abs()
    return dict(max_abs=float(err.max()),
                max_rel=float((err / (ref + 1e-3 * float(ref.max()) + 1e-30)).max()),
                ref_max=float(ref.max()))


@torch.no_grad()
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "stage_dump.json"))
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    card_name = subprocess.run(
        ["nvidia-smi", "-i", str(dev.index or 0), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True, text=True).stdout.strip()

    rng = np.random.default_rng(0)
    left = rng.standard_normal((1, H, W, 3)).astype(np.float32) * 0.3
    lt = torch.from_numpy(left)
    rt = torch.from_numpy(np.roll(left, -3, axis=2))
    bm, dm = random_pair(MAX_DISP, torch.Generator().manual_seed(0))
    calibrate_heads(bm, lt, rt, target_std=10.0)
    dm.load_state_dict(bm.state_dict(), strict=False)
    noise = torch.from_numpy(
        rng.uniform(size=(1, MAX_DISP // 4, H // 4, W // 4)).astype(np.float32))

    stages = {where: stage_list(*(fold_acv(copy.deepcopy(m).to(on)) for m in (bm, dm)))
              for where, on in (("cpu", torch.device("cpu")), ("cuda", dev))}
    inputs = {"left": lt, "right": rt, "noise": noise}
    cpu_state, card_state = dict(inputs), {k: v.to(dev) for k, v in inputs.items()}
    out = []
    with float32_exact(bm):
        for (name, ins, fn_cpu), (_, _, fn_card) in zip(stages["cpu"], stages["cuda"]):
            cpu_state[name] = fn_cpu(*(cpu_state[i] for i in ins))
            card_state[name] = fn_card(*(card_state[i] for i in ins))
            local = fn_card(*(cpu_state[i].to(dev) for i in ins))
            torch.cuda.synchronize()
            rec = dict(stage=name, propagated=compare(card_state[name], cpu_state[name]),
                       local=compare(local, cpu_state[name]))
            out.append(rec)
            print(f"{name:45s} propagated max_abs {rec['propagated']['max_abs']:.3e} max_rel "
                  f"{rec['propagated']['max_rel']:.3e} | local max_abs "
                  f"{rec['local']['max_abs']:.3e} max_rel {rec['local']['max_rel']:.3e} "
                  f"(|ref| ≤ {rec['local']['ref_max']:.3g})", flush=True)
        names = [s[0] for s in stages["cuda"]]
        starts = {}
        for start in ("trunk right", "attention logits", "concat volume × attention (row 3)",
                      "classif2_0", "DDIM volume × attention × noise (row 4)", "DDIM classif2_0"):
            state = {k: v.to(dev) for k, v in cpu_state.items()}
            for name, ins, fn in stages["cuda"][names.index(start) + 1:]:
                state[name] = fn(*(state[i] for i in ins))
            torch.cuda.synchronize()
            starts[start] = {k: compare(state[k], cpu_state[k])["max_abs"]
                             for k in ("disparity (row 1)", "DDIM disparity (row 1)")
                             if names.index(k) > names.index(start)}
            print(f"from the CPU's {start}: disparity max |Δ| {starts[start]}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card_name, "torch": torch.__version__, "stages": out,
                   "from": starts}, f, indent=1)
    print(card_name)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
