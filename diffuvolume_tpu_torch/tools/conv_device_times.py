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
every path and row 18 at the refinement's 11 convs, both dtypes checked,
bf16 timed.  ``--rows stride1`` limits it to the stride-1 rows (5, 6, 9, 14,
15, 18); ``--rows k1`` to row 9 at every shape of the ACV, PCW and IGEV
folded paths (with ``F.linear`` and ``F.conv3d`` as yardsticks); ``--rows
head`` to rows 1 and 17 at the ACV and PCW shapes, both align-corners
conventions (float32 timed).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO),
                    help="checkout whose diffuvolume_tpu_torch package is measured")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "conv_device_times.json"))
    ap.add_argument("--rows", choices=("all", "stride1", "k1", "head"), default="all",
                    help="stride1: only the cases of rows 5, 6, 9, 14, 15 and 18; k1: row 9; "
                         "head: rows 1 and 17")
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
             ("IGEV folded", cs.IGEV_CONV_CASES), ("IGEV module", cs.IGEV_SMALL_CASES),
             *((f"{m.upper()} module, routed", c) for m, c in cs.PACKED_CASES.items())]
    kinds = {"stride1": ("p", "k1"), "k1": ("k1",), "head": ()}.get(args.rows)
    if args.rows == "head":
        out["head"] = cs.head_checks(dev)
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
