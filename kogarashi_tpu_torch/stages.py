"""Per-stage wall time for setup and proving, logged at INFO.

When INFO is enabled for the logger, each mark synchronises the CUDA device
first, so a stage's time includes its device work; when it is not, a mark
costs one level check and the pipeline runs without extra synchronisation.
"""

from __future__ import annotations

import logging
import time

import torch


class Stages:
    def __init__(self, logger: logging.Logger, what: str, device):
        self.logger = logger
        self.what = what
        self.device = torch.device(device)
        self.on = logger.isEnabledFor(logging.INFO)
        self.t0 = self.t = time.perf_counter()

    def mark(self, stage: str) -> None:
        if not self.on:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.logger.info("%s %s: %.3f s", self.what, stage, now - self.t)
        self.t = now
