"""The mean wait for ``next(loader)`` a step over the window, by the
benchmark's clock around it."""


def read(rec):
    waits = rec['cell'].get('waits_s')
    if not waits:
        return None
    first, last = rec['window']
    w = waits[first:last]
    return 1e3 * sum(w) / len(w)
