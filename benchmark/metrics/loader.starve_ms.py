"""The mean time a step the consumer waited on the loader's workers for
the next finished batch, over the traced window: the program's
``loader.starve`` spans (``pyg_lib_tpu_torch.profiling.spans``), the part
of ``loader.wait_ms`` that waited on the workers."""


def read(rec):
    from pyg_lib_tpu_torch import profiling
    if not hasattr(profiling, 'spans'):  # a program without the recorder
        return None
    ms = [1e3 * s.seconds for s in profiling.spans()
          if s.name == 'loader.starve']
    if not ms:
        return None
    return sum(ms) / len(ms)
