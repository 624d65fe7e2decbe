"""TN: card transfers under a lock that is not a hot-path lock."""
import threading

import torch


class Cold:
    def __init__(self, device):
        self._lock = threading.Lock()
        self.device = device

    def load(self, rows):
        with self._lock:
            t = torch.as_tensor(rows, device=self.device)
            return t.sum().item()
