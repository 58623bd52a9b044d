"""Model FLOPs of a training step, from the configuration file alone.

Forward plus backward, recompute not counted: 6 x tokens x the matmul
parameters a token passes through (every projection, the MLP or the experts
it is routed to, the shared experts and the router, the output head; the
embedding lookup is no product), plus causal attention's ``QK^T`` and ``PV``
over the keys each query sees, at three times their forward.
"""

from __future__ import annotations

from .reference.model import dims

#: bf16 dense peak of one H100 SXM at 700 W (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
#: device-memory bandwidth of one H100 SXM (NVIDIA's data sheet)
PEAK_HBM_BYTES = 3.35e12


def active_matmul_params(cfg: dict) -> dict:
    """Matmul parameters a token passes through, by part."""
    d = dims(cfg)
    D, H = d["D"], d["H"]
    if d["mla"]:
        attn = D * H * (d["dn"] + d["dr"]) + D * (d["r"] + d["dr"]) \
            + d["r"] * H * (d["dn"] + d["dv"]) + H * d["dv"] * D
    else:
        attn = 2 * D * H * d["hd"] + 2 * D * d["Hkv"] * d["hd"]
    dense = 3 * D * d["F"]
    out = {"attention": d["L"] * attn, "head": D * d["V"]}
    if not d["moe"]:
        out["mlp"] = d["L"] * dense
        return out
    n_moe = d["L"] - d["n_dense"]
    out["mlp"] = d["n_dense"] * dense
    out["experts"] = n_moe * (3 * D * d["Fe"] * (d["k"] + d["n_shared"]) + D * d["E"])
    return out


def attention_flops_per_token(cfg: dict, seq_len: int) -> float:
    """Forward and backward of ``QK^T`` and ``PV`` a token, causal: a query sees
    ``(S + 1) / 2`` keys on average."""
    d = dims(cfg)
    dq, dv = (d["dn"] + d["dr"], d["dv"]) if d["mla"] else (d["hd"], d["hd"])
    ctx = (seq_len + 1) / 2
    return 3 * d["L"] * d["H"] * 2 * ctx * (dq + dv)


def flops_per_token(cfg: dict, seq_len: int) -> float:
    return 6 * sum(active_matmul_params(cfg).values()) + attention_flops_per_token(cfg, seq_len)
