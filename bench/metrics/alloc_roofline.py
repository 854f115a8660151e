"""The fused allocate's share of its HBM roofline: the bytes each launch
must move (``yardstick.alloc_launch_bytes``: the sizes read once, the shares
and chips written once, at the launch's shape) at 3.35 TB/s, over the
device time of the ``hesrpt_alloc_kernel`` rows of the trace."""

from bench import yardstick

KERNEL = "hesrpt_alloc_kernel"


def read(ctx):
    trace, per_launch = ctx.get("trace"), ctx.get("alloc_launch_bytes")
    if trace is None or not per_launch:
        return None
    rows = [r for name, r in trace["kernel_rows"].items() if KERNEL in name]
    launches, seconds = sum(r[0] for r in rows), sum(r[1] for r in rows)
    if not launches:
        return None
    return yardstick.roofline_share(launches * per_launch, seconds)
