"""Device peaks and work counts for roofline shares.

The reference's TIME channel (lib/config.c:117-130) only times host
stages; on an accelerator the number that separates "the host is slow"
from "the kernel is slow" is what fraction of the device's peak a kernel
achieves.  This module provides

  * `device_peaks()` — published (FP32 FLOP/s, HBM bytes/s) for the
    attached device, from one table keyed by `device_kind`; a device that
    is not in the table is an error, never a default;
  * work counts per launch (`chain_flops`, `chain_bytes`) that bench.py
    divides by kernel time.

Kernel times come from host clocks around work that ends in
`block_until_ready`.
"""
from __future__ import annotations

# device_kind -> (FP32 FLOP/s on the CUDA cores, HBM bytes/s).  Source:
# NVIDIA H100 Tensor Core GPU data sheet, "FP32" row (not a tensor-core
# rate: the chain DP's f32 (max,+) ops have no matrix product).  The data
# sheet counts a fused multiply-add as two FLOPs; max and add issue one
# instruction each, so a (max,+) kernel's flops share tops out at 0.5.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (67e12, 3.35e12),  # H100 SXM5
    "NVIDIA H100 PCIe": (51e12, 2.0e12),  # H100 PCIe
}


def device_peaks(kind: str | None = None) -> tuple[float, float, str]:
    """(peak_flops, peak_bytes_per_s, device_kind) for `kind`, default the
    first device's.  Raises KeyError for a device not in PEAKS."""
    if kind is None:
        import jax

        kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return (*PEAKS[kind], kind)


def chain_flops(n_cells: int) -> float:
    """Vector ops executed per task-1 chain cell (ops/tropical.py): the
    (max,+) composes of the forward scan and the traceback's relation
    composes (S^3 max+add each, twice over for the two-pass blocked
    scan), plus the pointer-selection scoring (64x8 lanes, ~3 ops)."""
    S = 8
    return n_cells * (2 * 2 * S ** 3 + 3 * 64 * 8)


def chain_bytes(n_cells: int) -> float:
    """Approximate device-memory bytes for one slot-plane chain launch:
    the transfer buffer (~8.5 B/cell at Emax=4), the [L, 64] f32
    transition lattice written+read, the [L, Emax, 8] masked-reduction
    traffic of the pointer passes, and the scan state/traceback
    tensors."""
    return n_cells * (9 + 64 * 4 * 2 + 4 * 8 * 4 * 3 + 8 * 4 * 6)
