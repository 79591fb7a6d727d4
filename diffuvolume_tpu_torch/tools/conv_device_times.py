"""Phase 3's fold-conv and head checks and times (``chip_smoke.conv_checks``,
``chip_smoke.head_checks``) for the package of another checkout, so that two
versions are compared in one call on one card.

    python diffuvolume_tpu_torch/tools/conv_device_times.py --root DIR [--rows ROWS] [--out FILE]

This checkout's ``chip_smoke.py`` does the measuring (device time from
torch.profiler, CUDA events, host time a call, the tensor-core forms where
the package has them); the ``diffuvolume_tpu_torch`` package and its kernels
come from ``--root`` (for example the parent commit, unpacked with
``git archive``).  Run it by its file path, as above: ``python -m`` would
import this checkout's package first.  Rows 5–9, 14 and 15 at every shape of
every path (``gwcnet-g``'s volume convs at C_in 48 among them) and row 18
at the refinement's 11 convs, both dtypes checked, bf16 timed.  ``--rows stride1`` limits it to the stride-1 rows (5, 6, 9, 14,
15, 18); ``--rows k1`` to row 9 at every shape of the ACV, PCW and IGEV
folded paths (with ``F.linear`` and ``F.conv3d`` as yardsticks); ``--rows
head`` to rows 1 and 17 at the ACV and PCW shapes, both align-corners
conventions (float32 timed); ``--rows front`` to row 16 at every shape of the
ACV, PCW, IGEV and ``gwcnet-g`` folded paths and row 10 (both stencils and the fused
pair; ``chip_smoke.front_checks``); a package from before the fused pair
(``--root`` of an older checkout) reports no plans and runs the pair as two
launches (``_older_front``).  ``--rows volume``: row 3 in both forms (the
NCDHW volume and the folded path's channels-last one), with and without
att, row 2 at the ACV and IGEV module paths' shapes with its plan, and row
4 (NCDHW, channels-last, PCW's one map) as the control; ``--rows layout``:
rows 11 and 12 at the ACV folded path's shape and row 13 at IGEV's two,
each beside the library copy.  A package from before rows 2, 3 and 11-12
had plans reports none (``_older_plans``).  With ``--sweep``, also the
tiles the plans chose among, bf16, device time, through this package's
``*_on`` entry points only: ``--rows front`` row 16 at each shape and the stencils at the ACV
shape (``front_sweep``); ``--rows volume`` row 3's W tiles, D ranges and
grids at the ACV shape and row 2's disparities an item and block sizes at
both shapes (``volume_sweep``); ``--rows
layout`` rows 11-12's lanes a tile column and grids, and the element-tile
form (``layout_sweep``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _older_front() -> None:
    """Let phase 3's ``front_checks`` run on a package from before rows 16
    and 10 reported plans and row 10 had its fused pair: no plan, and the
    pair as two single launches (what such a package's attention chain
    runs)."""
    from diffuvolume_tpu_torch.ops.kernels import depthwise as kd
    from diffuvolume_tpu_torch.ops.kernels import gwc_volume as kg

    if not hasattr(kg, "slot_plan"):
        kg.slot_plan = lambda *args, **kwargs: None
    if not hasattr(kd, "depthwise_plan"):
        kd.depthwise_plan = lambda *args, **kwargs: None
    if not hasattr(kd, "depthwise_hw_p2"):
        kd.depthwise_hw_p2 = lambda x, wt1, dil1, wt2, dil2: kd.depthwise_hw_p(
            kd.depthwise_hw_p(x, wt1, dil1), wt2, dil2)
        kd.depthwise_hw_plain2 = lambda x, wt1, dil1, wt2, dil2: kd.depthwise_hw_plain(
            kd.depthwise_hw_plain(x, wt1, dil1), wt2, dil2)


def _older_plans() -> None:
    """Let phase 3's volume and layout checks run on a package from before
    rows 2, 3 and 11-12 reported plans: no plan."""
    from diffuvolume_tpu_torch.ops.kernels import concat_volume as kc
    from diffuvolume_tpu_torch.ops.kernels import gwc_volume as kg
    from diffuvolume_tpu_torch.ops.kernels import layout as kl

    if not hasattr(kg, "gwc_plan"):
        kg.gwc_plan = lambda *args, **kwargs: None
    if not hasattr(kc, "concat_plan"):
        kc.concat_plan = lambda *args, **kwargs: None
    if not hasattr(kl, "transpose_plan"):
        kl.transpose_plan = lambda *args, **kwargs: None


def _timed(cs, fn, ref):
    """``fn``'s device time (``chip_smoke.device_times``, 10 calls) after
    holding its result equal to ``ref``; a forced form the card cannot
    launch gives the error's first line."""
    import torch

    try:
        got = fn()
    except (RuntimeError, ValueError) as e:
        return str(e).splitlines()[0][:80]
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("a forced form changed the result")
    return cs.device_times(fn, 10)["ms"]


def _fastest(rec: dict) -> list:
    return sorted((v, k) for k, v in rec.items() if isinstance(v, float))[:3]


def volume_sweep(cs, dev) -> dict:
    """Row 3's channels-last form at the ACV shape, bf16, with and without
    att: W tiles of 24-120 positions, all of D, half or a quarter a work
    item, the plan's grid, one block an SM or two items a block
    (``concat_volume_cl_on``)."""
    import itertools

    import torch

    from diffuvolume_tpu_torch.ops.kernels import concat_volume as kc

    g = torch.Generator().manual_seed(10)
    cl, cr = (torch.randn((1, cs.CAT_C, cs.H4, cs.W4), generator=g).to(dev).bfloat16()
              for _ in "lr")
    att = torch.softmax(torch.randn((1, cs.D4, cs.H4, cs.W4), generator=g), 1).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for label, a in (("with att", att.bfloat16()), ("without att", None)):
        call = lambda t=(0, 0, 0): kc.concat_volume_cl_on(t, cl, cr, cs.D4, a)  # noqa: E731
        ref = call()
        rec = {"plan": kc.concat_plan(1, cs.CAT_C, cs.H4, cs.W4, cs.D4, a is not None,
                                      torch.bfloat16, dev)}
        for tw, ds in itertools.product((24, 40, 48, 60, 80, 120),
                                        (cs.D4, cs.D4 // 2, cs.D4 // 4)):
            rec[f"{tw} W x {ds} D"] = _timed(cs, lambda: call((tw, ds, 0)), ref)
        p = rec["plan"]
        for blocks in (sms, -(-p["items"] // 2)):  # one block an SM; two items a block
            rec[f"plan's tile on {blocks} blocks"] = _timed(
                cs, lambda: call((p["tw"], p["ds"], blocks)), ref)
        out[label] = rec
        cs.log(f"  sweep row 3 {label}: plan {p}; fastest {_fastest(rec)}")
    out["gwc_volume"] = gwc_sweep(cs, dev)
    return out


def gwc_sweep(cs, dev) -> dict:
    """Row 2 at the ACV and IGEV module paths' shapes, bf16: one to three
    steps of 8 disparities an item or all of D, on blocks of 128, 256 or
    512 threads (``gwc_volume_on``)."""
    import itertools

    import torch

    from diffuvolume_tpu_torch.ops.kernels import gwc_volume as kg

    g = torch.Generator().manual_seed(12)
    out = {}
    shapes = (("ACV", cs.FEAT_C, cs.GROUPS, cs.FULL),
              ("IGEV", cs.IGEV_C, cs.IGEV_GROUPS, cs.G1))
    for label, c, groups, (d, h, w) in shapes:
        l, r = (torch.randn((1, c, h, w), generator=g).to(dev).bfloat16() for _ in "lr")
        call = lambda t=(0, 0): kg.gwc_volume_on(t, l, r, d, groups)  # noqa: E731
        ref = call()
        rec = {"plan": kg.gwc_plan(1, c, h, w, groups, d, torch.bfloat16, dev)}
        for ds, threads in itertools.product((8, 16, 24, d), (128, 256, 512)):
            rec[f"{ds} D an item, {threads} threads"] = _timed(
                cs, lambda: call((ds, threads)), ref)
        out[label] = rec
        cs.log(f"  sweep row 2 {label}: plan {rec['plan']}; fastest {_fastest(rec)}")
    return out


def layout_sweep(cs, dev) -> dict:
    """Rows 11-12 at the ACV folded path's shape, bf16: 2, 4 or 8 lanes a
    tile column, the plan's single wave or 1, 2 or 4 blocks an SM, and the
    element-tile form (``pack_on`` / ``unpack_on``)."""
    import itertools

    import torch

    from diffuvolume_tpu_torch.ops.kernels import layout as kl

    g = torch.Generator().manual_seed(11)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for label, c, c_slot, (d, h, w), _ in cs.LAYOUT_CASES:
        x = torch.randn((1, c, d, h, w), generator=g).to(dev).bfloat16()
        y = torch.randn((1, d, h, w, c), generator=g).to(dev).bfloat16()
        forms = {"pack": (lambda f=(0, 0): kl.pack_on(f, x, c_slot)),
                 "unpack": (lambda f=(0, 0): kl.unpack_on(f, y))}
        for name, call in forms.items():
            ref = call()
            rec = {}
            for lr, blocks in itertools.product((2, 4, 8), (0, sms, 2 * sms, 4 * sms)):
                rec[f"{lr} lanes, {blocks or 'plan'} blocks"] = _timed(
                    cs, lambda: call((lr, blocks)), ref)
            rec["element tiles"] = _timed(cs, lambda: call((1, 0)), ref)
            out[f"{name} {label}"] = rec
            cs.log(f"  sweep {name} {label}: fastest {_fastest(rec)}")
    # Row 13's classifier cost (one channel a slot) is the transposer's
    # pack of its (B, D, 1, H, W) view: its kernel and the transposer.
    d, h, w = cs.G1
    x = torch.randn((1, d, h, w, 1), generator=g).to(dev).bfloat16()
    ref = kl.unpack_hwdc(x, 1)
    out["unpack_hwdc cost"] = rec = {
        "unpack_hwdc": _timed(cs, lambda: kl.unpack_hwdc(x, 1), ref),
        "transposer": _timed(cs, lambda: kl.pack(x.view(1, d, 1, h, w)).view(1, h, w, d), ref)}
    cs.log(f"  sweep row 13 cost: {rec}")
    return out


def front_sweep(cs, dev) -> dict:
    """Rows 16 and 10 at other tiles than their plans' (the package's
    ``*_on`` entry points): each row-16 shape at W tiles of 8–120 positions,
    all of D or part of it a block; the ACV shape's stencils and fused pair
    at W tiles of 80, 120 and 240, one or two warps a channel vector, one or
    two blocks an SM.  bf16, device time
    (torch.profiler); each tile's result held equal to the plan's."""
    import itertools

    import torch

    from diffuvolume_tpu_torch.ops.kernels import depthwise as kd
    from diffuvolume_tpu_torch.ops.kernels import gwc_volume as kg

    g = torch.Generator().manual_seed(9)
    out = {"gwc_volume_packed": {}, "depthwise": {}}

    for vc in cs.VOLUME_CASES:
        d, h, w = vc.dhw
        l, r = (torch.randn((1, vc.c, h, w), generator=g).to(dev).bfloat16() for _ in "lr")
        cat = {k: torch.randn((1, vc.cc, h, w), generator=g).to(dev).bfloat16()
               for k in ("cat_l", "cat_r")} if vc.cc else {}
        call = lambda tile=(0, 0): kg.gwc_volume_packed_on(  # noqa: E731
            tile, l, r, d, vc.groups, vc.slot, mask_ref=vc.mask_ref, **cat)
        ref = call()
        rec = {"plan": kg.slot_plan(1, vc.c, vc.cc, h, w, d, vc.slot, torch.bfloat16, dev)}
        for tw, ds in itertools.product((8, 16, 32, 64, 120), sorted({d, -(-d // 2), 24})):
            if ds > d or tw > -(-w // 4) * 4:
                continue
            rec[f"{tw} W x {ds} D"] = _timed(cs, lambda: call((tw, ds)), ref)
        out["gwc_volume_packed"][vc.label] = rec
        cs.log(f"  sweep row 16 {vc.label}: plan {rec['plan']}; fastest {_fastest(rec)}")

    x = torch.randn((1, cs.D4, cs.H4, cs.W4, cs.ATT_SLOT), generator=g).to(dev).bfloat16()
    w1, w2 = (torch.randn((3, 3, cs.ATT_SLOT), generator=g).to(dev) for _ in "12")
    forms = {"patch": (lambda t=(0, 0, 0): kd.depthwise_hw_p_on(t, x, w1, cs.PATCH_DIL)),
             "patch_l123": (lambda t=(0, 0, 0): kd.depthwise_hw_p_on(t, x, w2,
                                                                     cs.PATCH_L123_DIL)),
             "pair": (lambda t=(0, 0, 0): kd.depthwise_hw_p2_on(t, x, w1, cs.PATCH_DIL, w2,
                                                                cs.PATCH_L123_DIL))}
    for name, call in forms.items():
        ref = call()
        rec = {}
        for tw, wpc, blocks in itertools.product((80, 120, 240), (1, 2), (132, 264)):
            rec[f"{tw} W, {wpc} warps a vector, {blocks} blocks"] = _timed(
                cs, lambda: call((tw, wpc, blocks)), ref)
        out["depthwise"][name] = rec
        cs.log(f"  sweep row 10 {name}: fastest {_fastest(rec)}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO),
                    help="checkout whose diffuvolume_tpu_torch package is measured")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "conv_device_times.json"))
    ap.add_argument("--sweep", action="store_true",
                    help="with --rows front, volume or layout: time the tiles the plans "
                         "chose among")
    ap.add_argument("--rows", choices=("all", "stride1", "k1", "head", "front", "volume",
                                       "layout"), default="all",
                    help="stride1: only the cases of rows 5, 6, 9, 14, 15 and 18; k1: row 9; "
                         "head: rows 1 and 17; front: rows 16 and 10; volume: rows 2-4; "
                         "layout: rows 11-13")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        print("conv_device_times: no CUDA device", file=sys.stderr)
        return 1
    import diffuvolume_tpu_torch

    if not diffuvolume_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"measuring {diffuvolume_tpu_torch.__file__}, not {root}'s package")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"root": root, "card": cs.card_line(), "paths": {}}
    paths = [("ACV", cs.CONV_CASES), ("PCW", cs.PCW_CONV_CASES),
             ("gwcnet-g", cs.GWCNET_G_CONV_CASES),
             ("IGEV folded", cs.IGEV_CONV_CASES), ("IGEV module", cs.IGEV_SMALL_CASES),
             *((f"{m.upper()} module, routed", c) for m, c in cs.PACKED_CASES.items())]
    kinds = {"stride1": ("p", "k1"), "k1": ("k1",), "head": (), "front": (), "volume": (),
             "layout": ()}.get(args.rows)
    if args.rows in ("volume", "layout"):
        _older_plans()
    if args.rows == "volume":
        out["volume"] = {"ncdhw": cs.kernel_checks(dev),
                         "gwc_volume_igev": cs.igev_gwc_checks(dev),
                         **cs.volume_cl_checks(dev), **cs.pcw_mul_checks(dev)}
        if args.sweep:
            out["volume_sweep"] = volume_sweep(cs, dev)
    if args.rows == "layout":
        out["layout"] = {**cs.layout_checks(dev), "unpack_hwdc": cs.hwdc_checks(dev)}
        if args.sweep:
            out["layout_sweep"] = layout_sweep(cs, dev)
    if args.rows == "head":
        out["head"] = cs.head_checks(dev)
    if args.rows == "front":
        _older_front()
        out["front"] = cs.front_checks(dev)
        if args.sweep:
            out["front_sweep"] = front_sweep(cs, dev)
    for path, cases in paths:
        cases = [c for c in cases if kinds is None or c.kind in kinds]
        if cases:
            out["paths"][path] = cs.conv_checks(dev, cases, path, iters=10)
    if args.rows in ("all", "stride1"):
        out["paths"]["PCW flat refinement"] = cs.refine_checks(dev)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(out["card"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
