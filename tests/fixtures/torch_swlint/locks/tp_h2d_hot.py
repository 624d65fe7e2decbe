"""LK004: host-to-card copies under a hot lock, one call below it."""
import threading

import numpy as np
import torch


def _upload(rows, device):
    return torch.from_numpy(np.asarray(rows)).pin_memory().to(
        device, non_blocking=True)


class Hot:
    def __init__(self, device):
        self._lock = threading.Lock()
        self.device = device
        self._buf = None

    def adopt(self, rows):
        with self._lock:
            self._buf = _upload(rows, self.device)

    def adopt_tensor(self, rows):
        with self._lock:
            self._buf = torch.as_tensor(rows, device=self.device)
            self._buf.copy_(torch.from_numpy(rows))
