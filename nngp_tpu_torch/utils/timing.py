"""Structured timing with the report format of `nngp_tpu.utils.timing`.

CUDA work is asynchronous, so on a CUDA device the timer synchronizes the
device before reading the clock at both ends of a measured block.
"""

import time
from contextlib import contextmanager

import torch


class Timer:
    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.records = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def measure(self, label: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.records[label] = time.perf_counter() - t0

    def report(self, printer=print):
        for label, secs in self.records.items():
            printer(f"[timing] {label}: {secs:.4f}s")
