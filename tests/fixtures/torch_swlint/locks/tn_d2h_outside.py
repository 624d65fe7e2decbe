"""TN: the epoch is read under the lock and copied off the card after
releasing it (the manager's query pattern)."""
import threading


class Mgr:
    def __init__(self, state):
        self._lock = threading.Lock()
        self._state = state

    def snapshot(self):
        with self._lock:
            s = self._state
        return s.cpu().numpy(), s.sum().item()
