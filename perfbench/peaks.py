"""The cards' published peaks and the byte counts the rooflines use.

Peaks are NVIDIA's data sheets, dense rates without sparsity, at the
card's full power limit (a card set below it runs slower under load: the
harness reports ``power.limit`` beside every run).
"""
from __future__ import annotations

__all__ = ["PEAKS", "peaks", "spmv_bytes"]

#: card name (as ``torch.cuda.get_device_name`` gives it, matched by
#: substring, first hit) -> bytes/s of memory and FLOP/s in float32
#: outside the tensor cores
PEAKS = (
    ("H100 PCIe", {"bytes_per_s": 2.0e12, "f32_flop_per_s": 51.2e12}),
    ("H100", {"bytes_per_s": 3.35e12, "f32_flop_per_s": 67.0e12}),
)


def peaks(device_name: str) -> dict | None:
    """The peaks of the card named ``device_name``, or ``None`` for a card
    the table does not hold (then no roofline share is reported)."""
    for key, p in PEAKS:
        if key in device_name:
            return p
    return None


def spmv_bytes(nnz: int, n: int) -> int:
    """The least bytes one float32 SpMV ``y = A x`` of an ``n``-row operator
    with ``nnz`` true entries moves: each entry's value and column once
    (4 + 4 B), ``x`` read once and ``y`` written once (4 B a row each).
    Stored padding and re-reads of ``x`` are the kernel's cost, not the
    operator's, so they are not counted."""
    return nnz * 8 + n * 4 + n * 4
