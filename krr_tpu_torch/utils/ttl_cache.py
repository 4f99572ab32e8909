"""A tiny TTL cache (the reference uses ``cachetools.TTLCache``; that package is
not a dependency, and the single use-site — service discovery,
`robusta_krr/utils/service_discovery.py:16-17` — only needs
get/set with expiry)."""

from __future__ import annotations

import time
from typing import Any, Hashable


class TTLCache:
    """Mapping with per-entry time-to-live and a max size (LRU-ish eviction)."""

    def __init__(self, maxsize: int = 128, ttl: float = 900.0) -> None:
        self.maxsize = maxsize
        self.ttl = ttl
        self._data: dict[Hashable, tuple[float, Any]] = {}

    def get(self, key: Hashable, default: Any = None) -> Any:
        entry = self._data.get(key)
        if entry is None:
            return default
        expires_at, value = entry
        if time.monotonic() >= expires_at:
            del self._data[key]
            return default
        return value

    def __setitem__(self, key: Hashable, value: Any) -> None:
        if key not in self._data and len(self._data) >= self.maxsize:
            # Evict the entry closest to expiry.
            oldest = min(self._data, key=lambda k: self._data[k][0])
            del self._data[oldest]
        self._data[key] = (time.monotonic() + self.ttl, value)

    def __contains__(self, key: Hashable) -> bool:
        return self.get(key, _MISSING) is not _MISSING

    def clear(self) -> None:
        self._data.clear()


_MISSING = object()
