"""The mean host time of the sampler's call a batch over the window's
batches, as the loader times it in its thread (``loader.timings``
``sample_ms``)."""


def read(rec):
    batches = rec['cell'].get('batches')
    if not batches:
        return None
    first, last = rec['window']
    ms = [b[2] for b in batches[first:last]]
    return sum(ms) / len(ms)
