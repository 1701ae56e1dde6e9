"""Device-memory probes (``EK_MEM_DEBUG=1``).

Counterpart of ``eigenkernel_tpu/obs/mem.py``.  ``memstats(tag)`` prints
one line of the CUDA caching allocator's statistics for the current
device: the bytes allocated now and at the peak, and the largest free
block the allocator holds, so that the live set of a failing step can be
read instead of modelled.
"""

from __future__ import annotations

import os
import sys

import torch


def memstats(tag: str, force: bool = False) -> dict | None:
    """Print one line of allocator stats when ``EK_MEM_DEBUG=1`` (or
    ``force``) and return ``torch.cuda.memory_stats()``; None when off or
    without a CUDA device."""
    if not force and os.environ.get("EK_MEM_DEBUG") != "1":
        return None
    if not torch.cuda.is_available():
        return None
    st = torch.cuda.memory_stats()
    largest_free = max((blk["size"] for seg in torch.cuda.memory_snapshot()
                        for blk in seg["blocks"]
                        if blk["state"] == "inactive"), default=0)
    gib = 1024 ** 3
    print(f"[mem] {tag}: "
          f"allocated={st.get('allocated_bytes.all.current', 0) / gib:.2f}G "
          f"peak={st.get('allocated_bytes.all.peak', 0) / gib:.2f}G "
          f"largest_free={largest_free / gib:.2f}G "
          f"retries={st.get('num_alloc_retries', 0)}",
          file=sys.stderr, flush=True)
    return st
