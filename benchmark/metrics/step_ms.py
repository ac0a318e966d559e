"""The window's length over the steps completed in it."""


def read(rec):
    return 1e3 * rec['window_s'] / rec['steps']
