"""Device/host memory budgeting.

Replaces the reference's RAM heuristics (set_window_process,
lib/nextpolish2.py:67-90, and smalloc's sleep-until-free back-pressure,
lib/ctg_cns.c:69-110) with static sizing: window length and device batch
width are derived from measured HBM / host RAM instead of letting a run
OOM and retry.
"""
from __future__ import annotations

import os


def host_available_bytes() -> int:
    """MemAvailable from /proc (the reference reads the same figure via
    psutil.virtual_memory().available)."""
    try:
        for line in open("/proc/meminfo"):
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 8 << 30


def device_free_bytes() -> int:
    """Free memory on the default device.  The CPU backend uses host
    memory; an accelerator that reports no memory stats is an error (a
    guessed size would mis-size every launch)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        return host_available_bytes()
    stats = dev.memory_stats() or {}
    limit = stats.get("bytes_limit") or stats.get("bytes_reservable_limit")
    if not limit:
        raise RuntimeError(
            f"{dev.device_kind} reports no memory limit (memory_stats: "
            f"{stats!r})")
    return int(limit - stats.get("bytes_in_use", 0))


def cns_device_batch(level_bytes_per_window: int, n_windows: int,
                     free_bytes: int | None = None,
                     fraction: float = 0.5) -> int:
    """How many engine-2 windows fit one device launch.

    level_bytes_per_window ~= Lt * 8 * Ep * 8 (the dense A+M slabs); the
    scan also holds its outputs (~Lt*6*5) and XLA working set, hence the
    conservative fraction."""
    free = device_free_bytes() if free_bytes is None else free_bytes
    per = max(level_bytes_per_window, 1)
    b = int(free * fraction) // per
    return max(1, min(b, n_windows))


# per-draft-base host bytes for tag/MSA columns by read type: noisier
# reads carry more insertion columns per position (ONT/CLR delta tracks
# are deeper than HiFi's, lib/ctg_cns.c:1213-1256 tag packing)
_CNS_BYTES_PER_BASE = {"ont": 14, "clr": 14, "rs": 14, "hifi": 8}


def cns_window_len(read_type: str, coverage_hint: int = 60,
                   avail_bytes: int | None = None,
                   requested: int = 5_000_000) -> tuple[int, bool]:
    """Clamp the consensus window (-w) to host memory, mirroring the
    shape of set_window_process: tag columns cost roughly
    coverage * bytes-per-base(read_type) on the host side.

    Returns (window, ram_clamped): ram_clamped is True only when host
    memory actually reduced the request — the 4*overlap+1 floor
    (lib/ctg_cns.c:3368) can *raise* a small request and must not be
    reported as a memory clamp."""
    avail = host_available_bytes() if avail_bytes is None else avail_bytes
    per_base = max(coverage_hint, 1) * _CNS_BYTES_PER_BASE.get(read_type, 12)
    cap = int(avail * 0.5) // per_base
    w = min(requested, max(cap, 1_000_000))
    ram_clamped = w < requested
    # ctg_cns_init requires w >= 4 * overlap + 1 (lib/ctg_cns.c:3368)
    w = max(w, 4_000_001)
    return w, ram_clamped and w < requested
