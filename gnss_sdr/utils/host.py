"""Host-side runtime tuning.

The receiver's host loop and the scene oracle allocate multi-MB NumPy
temporaries every block. glibc serves allocations above
M_MMAP_THRESHOLD (128 KB default) with a fresh mmap and returns them
with munmap — so every temporary's pages are first-touch faults. On
bare metal that costs microseconds; on demand-paged VMs (Firecracker
snapshots, lazy-restore memory) each fault can cost ~50-200 us and a
single 245 MB temporary takes SECONDS (measured: a 30 M-sample
``np.arange`` at 13 s cold vs 0.07 s from a warm heap — ~200x).

``tune_host_allocator`` raises the mmap/trim thresholds so big buffers
live on the sbrk heap and stay warm across allocations. Idempotent;
no-op where glibc is absent. Opt out with GNSS_SDR_NO_MALLOPT=1.
"""
from __future__ import annotations

import ctypes
import os

_done = False

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3


def tune_host_allocator(threshold_bytes: int = 1 << 30) -> bool:
    """Keep large allocations on the reusable heap (see module doc).

    Returns True when the thresholds were (already) applied.
    """
    global _done
    if _done:
        return True
    if os.environ.get("GNSS_SDR_NO_MALLOPT"):
        return False
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = (libc.mallopt(_M_MMAP_THRESHOLD, threshold_bytes) == 1
              and libc.mallopt(_M_TRIM_THRESHOLD, threshold_bytes) == 1)
    except OSError:
        return False
    _done = bool(ok)
    return _done
