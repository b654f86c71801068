"""The count of each kernel's work and the H100's published peaks (NVIDIA's
H100 SXM data sheet, dense rates: 495 TFLOP/s in TF32 on the tensor
cores, 67 TFLOP/s in float32 on the CUDA cores, 3.35 TB/s of HBM3).

Copied from the port's ``configs/flexvec.py`` with one change: the
operations are the useful ones, each counted once; how many products a
kernel issues for one (K1's split TF32 issues three) is its own choice
and not the work.  Bytes are each input read once and each output
written once.
"""

from __future__ import annotations

import dataclasses

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"tf32": 495e12, "f32": 67e12}


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    nbytes: float
    peak: str = "f32"

    def scaled(self, times: float) -> "Work":
        return Work(self.flops * times, self.nbytes * times, self.peak)


def bound_s(work: Work) -> float:
    """The least time one card takes: the bytes over the HBM rate or the
    operations over their peak, whichever is larger."""
    return max(work.nbytes / HBM_BYTES_S, work.flops / PEAK_FLOPS[work.peak])


def pem_score_work(n: int, d: int, b: int, esize: int = 4) -> Work:
    """K1: the corpus, both (d, B) query panels and the rows' ages read
    once, the (N, B) panel written once; 2 * N * d * 2B operations."""
    return Work(flops=4.0 * n * d * b,
                nbytes=n * d * esize + 2 * d * b * 4 + n * 4 + n * b * 4,
                peak="tf32")


def mmr_work(b: int, live: int, k: int, d: int, bucket: int = 0) -> Work:
    """K3: the live pool's rows and the (B, bucket) relevance read once,
    the picks written; one similarity row (2 * live * d) a step, k steps."""
    bucket = bucket or live
    return Work(flops=2.0 * b * k * live * d,
                nbytes=b * (live * d + bucket) * 4 + b * k * 8)

