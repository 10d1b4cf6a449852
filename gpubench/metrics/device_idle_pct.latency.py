"""device_idle_pct.latency: the share of the traced slice in which the card
ran no kernel, copy or set (torch.profiler), in percent."""


def read(r):
    t = r.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
