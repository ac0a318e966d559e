"""The most edges of a padded batch, pad edges included, that read one
source row (``np.bincount(row).max()``), as the mean over the batches
padded while the trace was on: the ``max_row_reads`` counter of the
program's ``sampler.pad`` spans (``pyg_lib_tpu_torch.profiling.spans``)."""


def read(rec):
    from pyg_lib_tpu_torch import profiling
    if not hasattr(profiling, 'spans'):  # a program without the recorder
        return None
    reads = [s.attrs['max_row_reads'] for s in profiling.spans()
             if s.name == 'sampler.pad' and 'max_row_reads' in s.attrs]
    if not reads:
        return None
    return sum(reads) / len(reads)
