"""TN: the host batch is staged on the card before the hot lock is taken;
under the lock only references move."""
import threading

import torch


class Hot:
    def __init__(self, device):
        self._lock = threading.Lock()
        self.device = device
        self._slots = []

    def stage(self, rows):
        staged = torch.from_numpy(rows).to(self.device, non_blocking=True)
        with self._lock:
            self._slots.append(staged)
