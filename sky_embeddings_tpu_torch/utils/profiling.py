"""Step timing (port of ``StepTimer`` from ``sky_embeddings_tpu/utils/profiling.py``).

PyTorch returns before the card finishes, so a window is closed by
recording a CUDA event on the current stream and waiting for it: the host
clock then spans the device work of every step in the window.
"""

from __future__ import annotations

import time
from typing import Optional

import torch


class StepTimer:
    """Rolling step timing: ``step()`` after each step (no sync), ``lap()``
    to sync and summarise the window since ``start()``; img/s given a batch
    size."""

    def __init__(self, batch_size: Optional[int] = None, device: str | torch.device = "cpu"):
        self.batch_size = batch_size
        self.device = torch.device(device)
        self._t0: Optional[float] = None
        self._steps = 0
        self.history: list[dict] = []

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def step(self) -> None:
        if self._t0 is None:
            self.start()
        self._steps += 1

    def _sync(self) -> None:
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            ev.synchronize()

    def lap(self) -> dict:
        """Wait for the device and summarise the window since ``start()``."""
        self._sync()
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        stats = {
            "steps": self._steps,
            "seconds": dt,
            "steps_per_sec": self._steps / dt if dt > 0 else float("nan"),
        }
        if self.batch_size:
            stats["img_per_sec"] = self._steps * self.batch_size / dt if dt > 0 else float("nan")
        self.history.append(stats)
        self.start()
        return stats
