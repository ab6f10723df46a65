"""kernels_roofline.<cell kind>: 100 x the sum of the least times of the
program's kernels' launches (K1 assign, K2 match, K4 the mpm backward,
K5 min-plus) in the profiled sub-window over the sum of their device
times. A launch's least time is ``arith``'s at the cell's shapes: the
larger of its bytes (each input read once, each output written once) at
the HBM rate and its operations at the fp32 (min-plus: add+min) rate.
K5 runs the EDT's two phases in turn, so each pair of its launches is
one EDT of the batch's labels."""

from benchmark import arith


def read(ctx):
    if ctx.trace is None:
        return None
    tl, cfg, mix = ctx.trace["timeline"], ctx.config, ctx.mix
    d, m = cfg["data"], cfg["model"]
    b, s, q = mix["batch"], d["shot"], d["query"]
    fh, fw = arith.feature_hw(cfg)
    n, c, p = fh * fw, m["out_channels"], m["protos"]
    esize = 2 if cfg["precision"]["encoder"] == "bf16" else 4
    work = arith.mpm_work(b, s, q, n, c, p, esize)
    h, w, z = d["height"], d["width"], b * q
    bounds = {
        "assign": arith.bound_ms(*work["assign"]),
        "match": arith.bound_ms(*work["match"]),
        "mpm_bwd": arith.bound_ms(*arith.mpm_backward_work(
            b, s, q, n, c, p, esize)),
        "minplus": (arith.minplus_bound(1, z, h, h, w)
                    + arith.minplus_bound(1, 1, z * h, w, w)) / 2,
    }
    least = spent = 0.0
    for key, bound in bounds.items():
        seconds, launches = tl.kernel(key)
        least += bound * launches
        spent += seconds * 1e3
    return 100.0 * least / spent if spent > 0 else None
