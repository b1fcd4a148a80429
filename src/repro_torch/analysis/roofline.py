"""Three-term roofline model for the NVIDIA H100 SXM (``repro.analysis.roofline``
with the card's constants).

    compute term    = FLOPs_per_chip / PEAK_FLOPS
    memory term     = HBM_bytes_per_chip / HBM_BW
    collective term = collective_bytes_per_chip / LINK_BW

The inputs come from the dry run (``launch.dryrun``: ``analysis.opcount``
over fake tensors, per chip).  MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D
(MoE) per ``analysis.flops``: the ratio MODEL_FLOPS / traced FLOPs exposes
remat / redundancy waste.  A collective byte count of ``None`` (not
measured: a single-process trace has no collectives) leaves the third term
out (``collective_s`` is ``None``), never 0.

The card these constants describe, and that ``PERF.md`` measures on: NVIDIA
H100 80GB HBM3, power limit 700.00 W.
"""
from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = 989e12      # dense bf16 on the tensor cores, H100 SXM (NVIDIA H100 datasheet)
HBM_BW = 3.35e12         # bytes/s, HBM3 (NVIDIA H100 datasheet)
# bytes/s one way over ALL of a card's NVLink 4 links: 18 links carry 900 GB/s
# in both directions together (NVIDIA H100 datasheet; NVIDIA Hopper
# architecture whitepaper), 450 GB/s each way; through the NVSwitch a
# collective's traffic spreads over every link
LINK_BW = 450e9


@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float | None
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float | None
    model_flops_per_chip: float = 0.0

    def _terms(self) -> dict:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return {name: t for name, t in terms.items() if t is not None}

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Perfect-overlap bound: max of the terms."""
        return max(self._terms().values())

    @property
    def useful_flops_ratio(self) -> float:
        if self.flops_per_chip <= 0:
            return 0.0
        return self.model_flops_per_chip / self.flops_per_chip

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the ideal roofline achieved by the step-time bound:
        (useful compute time) / (bound step time)."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return (self.model_flops_per_chip / PEAK_FLOPS) / t

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant, "step_time_s": self.step_time_s,
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "model_flops_per_chip": self.model_flops_per_chip,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline_terms(flops_per_chip: float, hbm_bytes_per_chip: float,
                   collective_bytes_per_chip: float | None,
                   model_flops_per_chip: float = 0.0) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops_per_chip / PEAK_FLOPS,
        memory_s=hbm_bytes_per_chip / HBM_BW,
        collective_s=(None if collective_bytes_per_chip is None
                      else collective_bytes_per_chip / LINK_BW),
        flops_per_chip=flops_per_chip,
        hbm_bytes_per_chip=hbm_bytes_per_chip,
        collective_bytes_per_chip=collective_bytes_per_chip,
        model_flops_per_chip=model_flops_per_chip,
    )
