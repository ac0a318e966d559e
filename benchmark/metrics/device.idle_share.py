"""1 - busy / wall over the traced window, in %; busy is the union of
the device's kernels, copies and memsets."""


def read(rec):
    tr = rec['trace']
    if not tr or tr['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - tr['busy_s'] / tr['window_s'])
