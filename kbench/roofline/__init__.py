"""The bytes and operations a kernel's launch needs at least, one file per
kernel (`roofline/<kernel>.py`, each with NAMES, the CUDA function names
the device trace shows, and `need(...)`, returning (bytes, operations)),
and the card's published peaks (NVIDIA H100 SXM data sheet, dense).

The counts are chip_smoke.py phase 3's, copied: every byte of each input
the kernel must read and each output byte, once. Phase 3 reads the data-
dependent terms (valid events, picks, queue depth, candidates) from the
captured inputs of one launch; the benchmark's launches replay inside
CUDA graphs, where no input is seen, so the readers pass the window's
averages from counters, or nothing where no counter holds the term: the
least time, and so the share, is then a lower bound."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def least_seconds(need_bytes: float, ops: float) -> float:
    return max(need_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
