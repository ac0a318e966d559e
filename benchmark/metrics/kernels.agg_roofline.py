"""The aggregation kernels' least times (``roofline/counts.py``) over the
traced window, over their device time in the trace, in %."""


def read(rec):
    tr = rec['trace']
    if not tr:
        return None
    device_s = sum(tr['agg_device_s'].values())
    if device_s <= 0:
        return None
    return 100.0 * tr['agg_least_s'] / device_s
