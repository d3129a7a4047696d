"""Structured timing: the counterparts of `nngp_tpu/utils/timing.py`
(`Timer`, `sync`, `timed`) with its report format.

CUDA work is asynchronous, so a measurement must wait for it: `sync`
synchronizes the CUDA device of every tensor it finds in a (nested tuple,
list or dict) tree, where the JAX package fetches one element per leaf;
`Timer` synchronizes its device at both ends of a measured block.
"""

import time
from contextlib import contextmanager

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for leaf in tree:
            yield from _tensors(leaf)
    elif isinstance(tree, dict):
        for leaf in tree.values():
            yield from _tensors(leaf)


def sync(tree):
    """Block until every tensor in `tree` is computed; returns `tree`."""
    for device in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(device)
    return tree


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


def timed(fn, *args, repeats: int = 1, **kwargs):
    """Run fn `repeats` times, sync each; return (result, best_seconds)."""
    best = float("inf")
    out = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = sync(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - t0)
    return out, best
