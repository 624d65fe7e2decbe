"""Device: the share of the traced sub-window in which no kernel or copy
ran on the card (1 - the union of their intervals over the window), in %."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return (1.0 - tr["busy_s"] / tr["window_s"]) * 100.0
