"""The model's FLOPs over the window's steps (``roofline/counts.py``: the
GEMMs and one add an edge and a feature a pass, over the real nodes and
edges), over the window's length and the card's f32 peak, in %."""


def read(rec):
    if not rec['window_flops'] or rec['window_s'] <= 0:
        return None
    rate = rec['window_flops'] / rec['window_s']
    return 100.0 * rate / rec['peaks']['f32_flops_per_s']
