"""The roofline model at the H100's constants: JAX's ``roofline/analysis.py``.

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs a chip      / PEAK_FLOPS
    memory     = HBM bytes a chip  / HBM_BW
    collective = collective bytes  / collective_bw(chips)

:class:`RooflineReport` and :func:`model_flops` are JAX's, their arithmetic
in the same order; only the constants are the card's.  JAX's
``collective_bytes`` and its ``while`` trip counts parse XLA's text and have
no counterpart here (:mod:`repro_torch.roofline.count` says why); the
collective bytes come from the analytic cell (``table.analytic_cell``).

Hardware constants, each from NVIDIA's H100 Tensor Core GPU datasheet for
the SXM5 80 GB part:

* ``PEAK_FLOPS`` = 989e12: dense bf16 tensor-core FLOP/s (1979 TFLOP/s is
  the figure with 2:4 sparsity);
* ``HBM_BW`` = 3.35e12: HBM3 bytes/s;
* ``NVLINK_BW`` = 450e9: NVLink 4, 900 GB/s a GPU in both directions, so
  450 GB/s one way, for meshes of up to :data:`NVLINK_CHIPS` = 8 chips, which
  fit one HGX H100 node;
* ``NIC_BW`` = 50e9: one 400 Gb/s NIC a GPU (ConnectX-7, as the HGX H100
  reference design pairs them), for meshes above 8 chips.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Optional

PEAK_FLOPS = 989e12          # bf16 dense, FLOP/s a chip (H100 SXM5 datasheet)
HBM_BW = 3.35e12             # bytes/s a chip (H100 SXM5 datasheet, HBM3)
NVLINK_BW = 450e9            # bytes/s a chip, one direction (NVLink 4: 900 GB/s both ways)
NIC_BW = 50e9                # bytes/s a chip across nodes (one 400 Gb/s NIC a GPU)
NVLINK_CHIPS = 8             # chips of one HGX H100 node, joined all to all by NVLink

#: the rule by which :func:`collective_bw` picks a rate, as the table records it
COLLECTIVE_RULE = (f"NVLink {NVLINK_BW:g} B/s for meshes of up to {NVLINK_CHIPS} chips "
                   f"(one HGX node), NIC {NIC_BW:g} B/s above")


def collective_bw(chips: int) -> float:
    """Bytes/s a chip of the collectives of a mesh of ``chips``: NVLink within
    one node of :data:`NVLINK_CHIPS`, the NIC beyond."""
    return NVLINK_BW if chips <= NVLINK_CHIPS else NIC_BW


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    collective_bytes_per_chip: float
    collectives: dict = field(default_factory=dict)
    model_flops: float = 0.0
    memory_per_device: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.hlo_flops_per_chip / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes_per_chip / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_chip / collective_bw(self.chips)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (FLOPs a chip x chips): remat/redundancy waste probe."""
        total = self.hlo_flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs / (chips x peak x roofline step time)."""
        t = self.step_time_s
        return self.model_flops / (self.chips * PEAK_FLOPS * t) if t else 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(
            compute_s=self.compute_s,
            memory_s=self.memory_s,
            collective_s=self.collective_s,
            bottleneck=self.bottleneck,
            step_time_s=self.step_time_s,
            useful_flops_fraction=self.useful_flops_fraction,
            mfu=self.mfu,
        )
        return d


def model_flops(
    cfg, shape, param_count: int, embed_params: int = 0, active_param_count: Optional[int] = None
) -> float:
    """6*N*D for training, 2*N*D for inference (N = non-embedding params)."""
    n = (active_param_count or param_count) - embed_params
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # decode: one token per seq
