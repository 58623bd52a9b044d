"""The port's own kernels' share of their roofline in a traced step.

Sum over the kernel calls of a step of each call's bound, the larger of its
operations at the bf16 dense peak and its bytes at the device memory's
bandwidth, over the device time of the port's kernels (the frozen grouping
of their names).  The calls are worked out from the configuration, as the
model makes them under remat "dots" (each block's forward kernels twice, the
final norm once, each backward once), and must match the wrappers'
``launches`` counters, or the reader returns nothing.  A call's operations
come from the frozen cost formulas; its bytes count each input read once and
each output written once, and only what the port's kernel itself reads and
writes: the SwiGLU backward's kernel computes ``dh = dy Wd^T`` and the gate,
and cuBLAS the weight gradients and dx beside it.
"""

import importlib

cost = importlib.import_module("hoardbench.frozen.cost")
flops_mod = importlib.import_module("hoardbench.flops")
dims = importlib.import_module("hoardbench.reference.model").dims

BF16 = 2


def _bound(flops, nbytes):
    return max(flops / flops_mod.PEAK_BF16_FLOPS, nbytes / flops_mod.PEAK_HBM_BYTES)


def calls(cfg, traffic):
    """``{wrapper: [(count, seconds of bound a call)]}`` of one training step."""
    d = dims(cfg)
    B, S = traffic["batch"], traffic["seq_len"]
    N, D, H = B * S, d["D"], d["H"]
    if d["mla"]:
        dq, dv, Hkv = d["dn"] + d["dr"], d["dv"], H
    else:
        dq = dv = d["hd"]
        Hkv = d["Hkv"]
    out = {k: [] for k in ("rmsnorm", "rmsnorm_bwd", "swiglu", "swiglu_bwd",
                           "flash_attention", "flash_attention_bwd")}

    def norm(rows, width, fwd_times):
        out["rmsnorm"].append((fwd_times, _bound(*cost.rmsnorm_cost(rows, width))))
        out["rmsnorm_bwd"].append((1, _bound(*cost.rmsnorm_bwd_cost(rows, width))))

    def swiglu(F):
        f, b = cost.swiglu_cost(N, D, F)
        out["swiglu"].append((2, _bound(f, b + 2 * N * F * BF16)))
        out["swiglu_bwd"].append((1, _bound(2.0 * N * D * F, (N * D + F * D + 5 * N * F) * BF16)))

    fl = cost.flash_attention_flops(B, H, S, S, dq, causal=True, head_dim_v=dv)
    io = (B * H * S * (dq + dv) + B * Hkv * S * (dq + dv)) * BF16 + B * H * S * 4
    blocks = [False] * d.get("n_dense", 0) + [d["moe"]] * (d["L"] - d.get("n_dense", 0))
    for moe in blocks:
        norm(N, D, 2)
        if d["mla"]:
            norm(N, d["r"], 2)
        out["flash_attention"].append((2, _bound(fl, io)))
        out["flash_attention_bwd"].append((1, _bound(cost.BACKWARD_FACTOR * fl,
                                                        2 * io - B * H * S * 4)))
        norm(N, D, 2)
        if not moe:
            swiglu(d["F"])
        elif d["n_shared"]:
            swiglu(d["n_shared"] * d["Fe"])
    norm(N, D, 1)
    return out


def read(run):
    t = run.trace
    if t is None or not t["own_s"]:
        return None
    expected = calls(run.config, run.traffic)
    counted = {k: v for k, v in t["calls"].items() if v}
    if counted != {k: sum(n for n, _ in v) for k, v in expected.items() if v}:
        return None
    bound = sum(n * s for v in expected.values() for n, s in v)
    return 100 * bound / (t["own_s"] / t["steps"])
