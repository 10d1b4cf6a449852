"""kernel_roofline_pct.latency: the least time the card could take for the
work of the traced slice's requests (bounds.image_bound_s, counted from
their shapes whatever kernels do it), over the summed time of every
kernel in the slice (torch.profiler), in percent."""


def read(r):
    t = r.trace
    if t is None or t.kernel_s <= 0 or not t.bound_s:
        return None
    return 100.0 * t.bound_s / t.kernel_s
