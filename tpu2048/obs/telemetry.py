"""Process + device memory telemetry.

Capability parity with the reference's psutil RSS sampling
(``/root/reference/game2048/start.py:131-141``, surfaced in the UI via
``application.py:172-173,464``): the host process RSS is sampled into
an appendable ``memory_usage.txt`` artifact on the heartbeat cadence —
and the device memory picture is sampled next to
it (``device.memory_stats()`` where the backend exposes it).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

from ..store.artifacts import ArtifactStore

MEMORY_KEY = "memory_usage.txt"


def process_rss_mb() -> float:
    """Resident set size of this process in MiB (psutil, with a /proc
    fallback; -1.0 if neither works)."""
    try:
        import psutil

        return psutil.Process().memory_info().rss / 2**20
    except Exception:  # noqa: BLE001 - psutil-less hosts
        try:
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
            return pages * os.sysconf("SC_PAGE_SIZE") / 2**20
        except Exception:  # noqa: BLE001
            return -1.0


def device_memory_stats() -> Dict[str, Any]:
    """HBM usage of the first local device, when the backend reports it
    (the GPU backend does; CPU returns {})."""
    try:
        import jax

        dev = jax.local_devices()[0]
        stats = dev.memory_stats() or {}
        out: Dict[str, Any] = {"device": str(dev)}
        for k in ("bytes_in_use", "bytes_limit", "peak_bytes_in_use"):
            if k in stats:
                out[k] = int(stats[k])
        return out if len(out) > 1 else {}
    except Exception:  # noqa: BLE001 - no jax / no devices
        return {}


def snapshot() -> Dict[str, Any]:
    """One telemetry sample: wall time, host RSS, device HBM."""
    s: Dict[str, Any] = {
        "time": time.time(),
        "rss_mb": round(process_rss_mb(), 1),
    }
    dm = device_memory_stats()
    if dm:
        s["hbm_in_use_mb"] = round(dm.get("bytes_in_use", 0) / 2**20, 1)
        if "bytes_limit" in dm:
            s["hbm_limit_mb"] = round(dm["bytes_limit"] / 2**20, 1)
        s["device"] = dm.get("device", "")
    return s


class MemoryMonitor:
    """Appends telemetry lines to the ``memory_usage.txt`` artifact
    (the reference's file of the same name), rate-limited so heartbeat
    callers can invoke it unconditionally."""

    def __init__(self, store: Optional[ArtifactStore],
                 min_interval: float = 30.0, max_lines: int = 2000):
        self.store = store
        self.min_interval = min_interval
        self.max_lines = max_lines
        self._last = 0.0

    def sample(self, tag: str = "") -> Optional[Dict[str, Any]]:
        now = time.time()
        if now - self._last < self.min_interval:
            return None
        self._last = now
        s = snapshot()
        if self.store is not None:
            line = (
                f"{time.strftime('%Y-%m-%d %H:%M:%S')} "
                f"rss = {s['rss_mb']} MiB"
            )
            if "hbm_in_use_mb" in s:
                line += f", hbm = {s['hbm_in_use_mb']} MiB"
                if "hbm_limit_mb" in s:
                    line += f" / {s['hbm_limit_mb']} MiB"
            if tag:
                line += f" ({tag})"
            self.store.append_text(MEMORY_KEY, line + "\n")
            self._trim()
        return s

    def _trim(self) -> None:
        """Keep the artifact bounded (the reference let its file grow
        without bound — a known wart, not a capability)."""
        text = self.store.load(MEMORY_KEY) or ""
        lines = text.splitlines()
        if len(lines) > self.max_lines:
            self.store.save(
                MEMORY_KEY, "\n".join(lines[-self.max_lines:]) + "\n"
            )

    def tail(self, max_chars: int = 4000) -> str:
        if self.store is None:
            return ""
        return (self.store.load(MEMORY_KEY) or "")[-max_chars:]
