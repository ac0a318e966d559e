"""The mean host time a batch of gathering its feature and label rows into
pinned memory, in the loader's worker, over the batches gathered while the
trace was on: the program's ``loader.gather`` spans
(``pyg_lib_tpu_torch.profiling.spans``)."""


def read(rec):
    from pyg_lib_tpu_torch import profiling
    if not hasattr(profiling, 'spans'):  # a program without the recorder
        return None
    ms = [1e3 * s.seconds for s in profiling.spans()
          if s.name == 'loader.gather']
    if not ms:
        return None
    return sum(ms) / len(ms)
