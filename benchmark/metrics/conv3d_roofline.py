"""The 3-D convolutions' share of their roofline (%): the least time of a
pair's dense 3-D convolution and transposed-convolution work, counted over
the reference at the cell's shapes (operations 2·MACs; input, weight and
output bytes once each in the configuration's dtype; the larger of
operations over the dtype's peak and bytes over the memory's, summed over
the calls), over the device time of the program's folded 3-D conv kernels
(rows 5–9) in the traced slice."""

from benchmark.counting import least_seconds

GROUPS = ("port: 3-D conv, folded (conv3d_fold.cu)",
          "port: transposed conv, folded (conv3d_up.cu)")


def read(ctx):
    spent = sum(dur for name, _, dur in ctx["ops"] if ctx["group_of"](name) in GROUPS)
    if ctx["phase"] != "eval" or spent <= 0:
        return None
    p = ctx["peaks"]
    least = least_seconds(ctx["work"]["conv3d"], p["flops"][ctx["peak_dtype"]],
                          p["hbm_bytes_per_s"]) * ctx["calls"]
    return 100.0 * least / spent
