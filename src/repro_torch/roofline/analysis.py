"""Three-term roofline from a counted dry run (no hardware needed).

The port of ``repro.roofline.analysis``:

    compute term    = flops            / (chips x peak FLOP/s)
    memory term     = bytes            / (chips x HBM rate)
    collective term = collective bytes / (chips x link rate)

The reference reads flops and bytes from XLA's ``cost_analysis()`` and the
collective bytes from the compiled HLO text.  The port compiles no HLO:
each architecture counts its own work, kernel by kernel
(:class:`KernelWork`), and its own collectives, per device
(``ArchSpec.step_cost``); :func:`analyze` scales those to the fleet.  The
same per-kernel count gives a kernel's least time on one card
(:meth:`Hardware.bound_s`), which ``chip_smoke.py`` prints beside the
kernel's measured time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One NVIDIA H100 SXM at its 700 W limit (NVIDIA's H100 data sheet,
    dense rates without sparsity; NVLink 4 as in the Hopper architecture
    white paper: 900 GB/s a card, all to all)."""

    peak_flops: float = 989e12      # bf16 on the tensor cores, dense
    tf32_flops: float = 495e12      # TF32 on the tensor cores, dense
    f32_flops: float = 67e12        # f32 on the CUDA cores
    hbm_bw: float = 3.35e12         # bytes/s of HBM3
    link_bw: float = 450e9          # bytes/s of NVLink, each direction

    def rate(self, peak: str) -> float:
        """FLOP/s of one kind of operation: "bf16", "tf32" or "f32"."""
        return {"bf16": self.peak_flops, "tf32": self.tf32_flops,
                "f32": self.f32_flops}[peak]

    def bound_s(self, work: "KernelWork") -> float:
        """The least time one card takes for the work: its bytes over the
        HBM rate or its operations over their peak, whichever is larger."""
        return max(self.bytes_s(work), self.ops_s(work))

    def bytes_s(self, work: "KernelWork") -> float:
        return work.nbytes / self.hbm_bw

    def ops_s(self, work: "KernelWork") -> float:
        return work.flops * work.passes / self.rate(work.peak)

    def bound_by(self, work: "KernelWork") -> str:
        return "bytes" if self.bytes_s(work) >= self.ops_s(work) else "operations"


HW = Hardware()


@dataclasses.dataclass(frozen=True)
class KernelWork:
    """What one kernel call must do on one device.

    ``flops`` are the useful operations, ``nbytes`` each input read once
    and each output written once.  ``peak`` names the rate the kernel's
    operations run at, and ``passes`` how many operations it issues for
    each useful one (split TF32 issues three products for an f32 corpus,
    two for bf16)."""

    flops: float
    nbytes: float
    peak: str = "f32"
    passes: int = 1


@dataclasses.dataclass(frozen=True)
class StepCost:
    """One device's count of a step: its kernels' work, its collectives'
    bytes by op, and the bytes of its intermediates (the peak of the
    temporaries it holds)."""

    kernels: Dict[str, KernelWork]
    collectives: Dict[str, float]
    temp_bytes: float

    @property
    def flops(self) -> float:
        return sum(w.flops for w in self.kernels.values())

    @property
    def nbytes(self) -> float:
        return sum(w.nbytes for w in self.kernels.values())

    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collective_by_op: Dict[str, int]
    model_flops: Optional[float] = None   # analytic useful work
    per_device_memory: Optional[Dict[str, float]] = None
    hw: Hardware = HW

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * self.hw.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * self.hw.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * self.hw.link_bw)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        if not self.model_flops or self.hlo_flops == 0:
            return None
        return self.model_flops / self.hlo_flops

    @property
    def roofline_fraction(self) -> float:
        """max-term model: fraction of the binding roof actually utilized by
        useful work. For compute-bound cells this is MODEL_FLOPS/(chips*peak)
        over the step's critical time (= max term)."""
        tmax = max(self.t_compute, self.t_memory, self.t_collective)
        if tmax == 0:
            return 0.0
        useful = (self.model_flops or self.hlo_flops) / (self.chips * self.hw.peak_flops)
        return useful / tmax

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "collective_by_op": self.collective_by_op,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "per_device_memory": self.per_device_memory,
        }


def analyze(
    arch: str, shape: str, mesh_name: str, chips: int,
    flops: float, nbytes: float, collective_bytes: float,
    collective_by_op: Optional[Dict[str, float]] = None,
    model_flops: Optional[float] = None,
    memory_stats: Optional[Dict[str, float]] = None,
) -> RooflineReport:
    """Build a report from PER-DEVICE counts (flops, bytes, collective
    bytes and their split by op), scaled here to fleet totals."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=float(flops) * chips,
        hlo_bytes=float(nbytes) * chips,
        collective_bytes=float(collective_bytes) * chips,
        collective_by_op={k: int(v) * chips
                          for k, v in (collective_by_op or {}).items()},
        model_flops=model_flops,
        per_device_memory=memory_stats,
    )
