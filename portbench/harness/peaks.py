"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3) and the roofline
arithmetic the per-layer metrics share.

Peaks: NVIDIA's H100 data sheet, SXM part, dense rates (no sparsity), at
the card's full 700 W: HBM3 3.35 TB/s; int8 1,979 TOP/s and bf16 989
TFLOP/s on the tensor cores; float32 67 TFLOP/s outside the tensor cores.
A run names the card and its power limit beside the shares, since a card
set below 700 W runs slower under load.

A layer's bound is the least time the card could take for it: each input
byte read once and each output byte written once at the HBM rate, or its
operations at its precision's peak, whichever is longer (the same rule as
``work`` in the repository's ``chip_smoke.py``, of which this is a copy).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
BYTES = {"int8": 1, "bf16": 2, "f32": 4}


def bound_s(nbytes: float, ops: float, precision: str) -> float:
    """Seconds: ``nbytes`` across HBM once, or ``ops`` at the peak of
    ``precision``, the longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[precision])


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def macs(row: dict) -> int:
    """Multiply-accumulates of one application of a layer-table row: a conv
    (``in`` and ``out`` as ``[H, W, C]``, ``kernel`` as ``[kh, kw]``) or a
    fully connected layer (``in`` ``[D]``, ``out`` ``[C]``); 0 for a pool."""
    if row["op"] == "conv":
        kh, kw = row["kernel"]
        return _numel(row["out"]) * kh * kw * row["in"][2]
    if row["op"] == "fc":
        return row["in"][0] * row["out"][0]
    return 0


def ops(row: dict) -> int:
    """Operations of one application: 2 a multiply-accumulate, or one
    comparison or addition per window cell and output value of a pool."""
    if row["op"] in ("conv", "fc"):
        return 2 * macs(row)
    kh, kw = row["kernel"]
    return _numel(row["out"]) * kh * kw


def nbytes(row: dict) -> int:
    """Bytes of one application: input and weights read once and output
    written once in the row's precision, and a float32 scale and bias an
    output channel (an int8 layer's requantizing epilogue) or a bias in
    the row's precision."""
    b = BYTES[row["precision"]]
    n = (_numel(row["in"]) + _numel(row["out"])) * b
    if row["op"] in ("conv", "fc"):
        cout = row["out"][-1]
        n += (macs(row) // _numel(row["out"][:-1])) * b
        n += cout * (8 if row["precision"] == "int8" else b)
    return n


def row_bound_s(row: dict) -> float:
    """The row's bound in seconds for one application."""
    return bound_s(nbytes(row), ops(row), row["precision"])


def peak_seconds(row: dict) -> float:
    """The row's operations at its precision's peak, in seconds (what the
    model-FLOP utilisation counts)."""
    return ops(row) / PEAK_OPS_PER_S[row["precision"]]
