"""Fixed-size lossy concurrent translation cache.

Replicates the reference AtomicCache (slimt/Cache.hh:9-58): a
direct-indexed record array (no probing, overwrite on collision) with
bucketed locks. Keys are the 64-bit request hashes from
slimt_jax.runtime.request.cache_key.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional, Tuple


class AtomicCache:
    def __init__(self, size: int, buckets: int = 16):
        if size <= 0:
            raise ValueError("cache size must be positive")
        self._records: List[Optional[Tuple[int, Any]]] = [None] * size
        self._locks = [threading.Lock() for _ in range(min(buckets, size))]
        # Observability counters (racy-read OK; writes under the
        # bucket lock). Surfaced by /stats and bench realcorpus.
        self.hits = 0
        self.misses = 0

    def find(self, key: int) -> Tuple[bool, Any]:
        index = key % len(self._records)
        with self._locks[index % len(self._locks)]:
            record = self._records[index]
            if record is not None and record[0] == key:
                self.hits += 1
                return True, record[1]
            self.misses += 1
        return False, None

    def store(self, key: int, value: Any) -> None:
        index = key % len(self._records)
        with self._locks[index % len(self._locks)]:
            self._records[index] = (key, value)


def make_cache(cache_size: int) -> Optional[AtomicCache]:
    """cache_size == 0 disables caching (slimt/Frontend.cc:79-85)."""
    if cache_size > 0:
        return AtomicCache(cache_size, buckets=16)
    return None
