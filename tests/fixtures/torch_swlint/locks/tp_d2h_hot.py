"""LK004: blocking card-to-host reads under a device-state manager's
lock."""
import threading

import torch


class Mgr:
    def __init__(self, state):
        self._lock = threading.Lock()
        self._state = state

    def count(self):
        with self._lock:
            return self._state.sum().item()

    def snapshot(self):
        with self._lock:
            return self._state.cpu().numpy()

    def settle(self, done):
        with self._lock:
            done.synchronize()
            torch.cuda.synchronize()
