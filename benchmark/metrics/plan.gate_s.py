"""Seconds the plan build spent on the gain estimates that decide its
``'auto'`` choices (``dedup='auto'`` on both sides): the sum of the
program's set-up ``plan.gate`` spans (``pyg_lib_tpu_torch.profiling.
spans``)."""


def read(rec):
    from pyg_lib_tpu_torch import profiling
    if not hasattr(profiling, 'spans'):  # a program without the recorder
        return None
    gates = [s.seconds for s in profiling.spans() if s.name == 'plan.gate']
    if not gates:
        return None
    return sum(gates)
