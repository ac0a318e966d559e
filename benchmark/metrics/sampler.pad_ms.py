"""The mean host time a batch of padding the sample into its bucket, in
the loader's worker, over the batches padded while the trace was on: the
program's ``sampler.pad`` spans (``pyg_lib_tpu_torch.profiling.spans``)."""


def read(rec):
    from pyg_lib_tpu_torch import profiling
    if not hasattr(profiling, 'spans'):  # a program without the recorder
        return None
    ms = [1e3 * s.seconds for s in profiling.spans()
          if s.name == 'sampler.pad']
    if not ms:
        return None
    return sum(ms) / len(ms)
