"""The card's published peaks and the least time a piece of work can take.

NVIDIA's H100 SXM data sheet, dense rates: 3.35 TB/s of HBM and 67
TFLOP/s of float32 outside the tensor cores, at the full power limit of
700 W (a run prints the card's own limit). The program computes in
float32 with TF32 off, so float32 is the rate its FLOPs are held to."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def least_seconds(bytes_moved: float, flops: float) -> float:
    """The larger of the bytes at the HBM rate and the FLOPs at the
    float32 rate: count each input byte read once and each output byte
    written once."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
