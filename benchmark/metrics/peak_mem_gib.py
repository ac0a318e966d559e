"""``torch.cuda.max_memory_allocated()`` from process start to the end of
the window, in GiB."""


def read(rec):
    return rec['peak_bytes'] / 2**30 if rec['peak_bytes'] else None
