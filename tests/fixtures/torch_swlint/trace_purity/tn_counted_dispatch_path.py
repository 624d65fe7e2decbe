"""TN: the dispatch path's sync goes through the counted surface."""


class Dispatcher:
    def __init__(self, metrics):
        self.host_syncs = metrics

    def fetch(self, done, out):
        self.host_syncs.inc()
        done.synchronize()
        return out.cpu()
