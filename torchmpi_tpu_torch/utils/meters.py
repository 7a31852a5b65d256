"""Training meters: counterpart of ``torchmpi_tpu/utils/meters.py``.

``AverageValueMeter.add`` takes Python numbers or tensors; a tensor is kept
as it is and read in one batch when the meter is, so the training loop
does not wait on the device for every step's loss.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch


class AverageValueMeter:
    """Running mean and standard deviation of scalar values."""

    _MAX_PENDING = 512

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.sum = 0.0
        self.sum_sq = 0.0
        self._pending = []

    def add(self, value, n: int = 1) -> None:
        if isinstance(value, torch.Tensor):
            self._pending.append((value.detach(), n))
            self.n += n
            if len(self._pending) >= self._MAX_PENDING:
                self._fold()
            return
        self.sum += value * n
        self.sum_sq += value * value * n
        self.n += n

    def _fold(self) -> None:
        if not self._pending:
            return
        vals = torch.stack([v.reshape(()).double().cpu()
                            for v, _ in self._pending]).numpy()
        ws = np.asarray([n for _, n in self._pending], np.float64)
        self.sum += float((vals * ws).sum())
        self.sum_sq += float((vals * vals * ws).sum())
        self._pending = []

    def value(self):
        if self.n == 0:
            return float("nan"), float("nan")
        self._fold()
        mean = self.sum / self.n
        var = max(self.sum_sq / self.n - mean * mean, 0.0)
        return mean, math.sqrt(var)

    @property
    def mean(self) -> float:
        return self.value()[0]


class ClassErrorMeter:
    """Top-k classification error in percent."""

    def __init__(self, topk: Sequence[int] = (1,)) -> None:
        self.topk = tuple(topk)
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.errors = {k: 0 for k in self.topk}

    def add(self, logits, targets) -> None:
        logits = np.asarray(torch.as_tensor(logits).detach().cpu())
        targets = np.asarray(torch.as_tensor(targets).cpu()).reshape(-1)
        n = targets.shape[0]
        order = np.argsort(-logits.reshape(n, -1), axis=1)
        for k in self.topk:
            hit = (order[:, :k] == targets[:, None]).any(axis=1)
            self.errors[k] += int(n - hit.sum())
        self.n += n

    def value(self, k: Optional[int] = None) -> float:
        if k is None:
            k = self.topk[0]
        if self.n == 0:
            return float("nan")
        return 100.0 * self.errors[k] / self.n
