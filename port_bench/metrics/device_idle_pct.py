"""Device (H100): the share of the traced window in which no operation ran
on the card, from the union of the device events' intervals in the
profiler's trace."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["device_events"] or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
