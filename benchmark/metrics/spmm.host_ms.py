"""The mean host time a call of the planned SpMM's forward and backward
over the traced window, launches included: the program's ``ops.spmm`` and
``ops.spmm.backward`` spans (``pyg_lib_tpu_torch.profiling.spans``)."""


def read(rec):
    from pyg_lib_tpu_torch import profiling
    if not hasattr(profiling, 'spans'):  # a program without the recorder
        return None
    ms = [1e3 * s.seconds for s in profiling.spans()
          if s.name in ('ops.spmm', 'ops.spmm.backward')]
    if not ms:
        return None
    return sum(ms) / len(ms)
