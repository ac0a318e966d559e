"""The share of a padded batch's edge slots that hold pad edges, in %, over
the batches the loader's workers padded while the trace was on: 100 *
sum(edge_slots - edges) / sum(edge_slots) of the program's
``sampler.pad`` spans (``pyg_lib_tpu_torch.profiling.spans``)."""


def read(rec):
    from pyg_lib_tpu_torch import profiling
    if not hasattr(profiling, 'spans'):  # a program without the recorder
        return None
    pads = [s.attrs for s in profiling.spans() if s.name == 'sampler.pad']
    slots = sum(a['edge_slots'] for a in pads)
    if not slots:
        return None
    return 100.0 * sum(a['edge_slots'] - a['edges'] for a in pads) / slots
