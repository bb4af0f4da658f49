"""Device telemetry ring buffers (port of eidola_tpu/utils/monitor.py).

Analog of the reference's NvmlMonitor (ref src/nvml_monitor.hpp:36-60,
polled once per frame at sample_example.cpp:378-380): the memory the
caching allocator holds on a CUDA device (torch.cuda.memory_allocated,
against the card's total from torch.cuda.mem_get_info) and the host
process's RSS, in fixed-size ring buffers.  On the CPU the device part
stays empty.
"""
from __future__ import annotations

import time
from collections import deque

import torch


class DeviceMonitor:
    def __init__(self, device, interval_s: float = 0.1, capacity: int = 256):
        self.device = torch.device(device)
        self.interval_s = interval_s
        self.capacity = capacity
        self.bytes_in_use: deque = deque(maxlen=capacity)
        self.bytes_limit: int | None = None
        self.host_rss: deque = deque(maxlen=capacity)
        self._last = 0.0
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self.bytes_limit = int(torch.cuda.mem_get_info(self.device)[1])

    def refresh(self):
        """Call once per frame; rate-limited internally (ref nvml_monitor
        refresh cadence)."""
        now = time.monotonic()
        if now - self._last < self.interval_s:
            return
        self._last = now
        if self._cuda:
            self.bytes_in_use.append(
                int(torch.cuda.memory_allocated(self.device)))
        try:
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
            self.host_rss.append(pages * 4096)
        except OSError:
            pass

    def summary(self) -> str:
        rss = self.host_rss[-1] / 2**20 if self.host_rss else 0.0
        if not self._cuda:
            return f"device {self.device}: host RSS {rss:.0f} MiB"
        dev = self.bytes_in_use[-1] / 2**20 if self.bytes_in_use else 0.0
        return (f"device {torch.cuda.get_device_name(self.device)}: "
                f"allocated {dev:.0f}/{self.bytes_limit / 2**20:.0f} MiB, "
                f"host RSS {rss:.0f} MiB")
