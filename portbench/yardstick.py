"""The benchmark's fixed yardstick: the card's peaks, the work that one
ed25519 verification needs, and the statistics the end-to-end metrics
use.  Later changes to the program cannot move these numbers.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet and the Hopper white
paper): HBM3 at 3.35 TB/s, and integer issue of 132 SMs x 128 lanes x
1.98 GHz = 3.345e13 int32 operations a second (integer multiply-adds run
on the FP32 datapath beside the INT32 lanes; the data sheet's 67 TFLOP/s
of float32, an FMA counting 2, is the same rate).

The work of one signature is frozen from the bound the port's smoke
test has used since its first kernel (M field multiplies and S field
squarings a signature; a multiply is 100 limb products at 2 operations,
10 folds at 4 and 11 carry steps at 8; a squaring 55 products and the
same fold and carry).  It counts what a signature verified needs,
whatever kernel does it and however many padding lanes it runs.
"""
from __future__ import annotations

import statistics

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 128 * 132 * 1.98e9

OPS_PER_FIELD_MUL = 2 * 100 + 4 * 10 + 8 * 11
OPS_PER_FIELD_SQR = 2 * 55 + 4 * 10 + 8 * 11
MULS_PER_SIG = 2039
SQRS_PER_SIG = 1546
OPS_PER_SIG = MULS_PER_SIG * OPS_PER_FIELD_MUL + \
    SQRS_PER_SIG * OPS_PER_FIELD_SQR
# A and R (32 B each) and the s and k windows (64 B each) in, one
# verdict byte out
BYTES_PER_SIG = 32 + 32 + 64 + 64 + 1


def least_seconds(sigs: int) -> float:
    """The least time the card could take to verify ``sigs``
    signatures: the larger of the operations over the issue rate and
    the bytes over the memory rate."""
    return max(sigs * OPS_PER_SIG / INT32_OPS_PER_S,
               sigs * BYTES_PER_SIG / HBM_BYTES_PER_S)


def p95(values) -> float:
    """The 95th percentile, interpolated between the nearest ranks."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[94]
