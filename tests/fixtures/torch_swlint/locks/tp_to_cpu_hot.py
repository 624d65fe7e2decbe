"""LK004: .to("cpu") and .tolist() of card state under the hot lock."""
import threading


class Mgr:
    def __init__(self, state):
        self._lock = threading.Lock()
        self._state = state

    def rows(self):
        with self._lock:
            host = self._state.to("cpu")
            return host, self._state.tolist()
