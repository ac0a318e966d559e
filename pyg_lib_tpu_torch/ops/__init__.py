"""Device ops of the port: planned SpMM over chunked and dedup plans."""

from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import (
    SpmmPlan, auto_chunk, build_spmm_plan, quantize_columns, spmm_chunked,
    spmm_chunked_plain, spmm_plan_apply)
from pyg_lib_tpu_torch.ops.kernels.spmm_dedup import (DedupSpmmPlan,
                                                      build_dedup_plan,
                                                      dedup_plan_apply,
                                                      dedup_sum,
                                                      dedup_sum_plain,
                                                      estimate_dedup)
from pyg_lib_tpu_torch.ops.spmm import SpmmGraph, build_spmm_graph, spmm

__all__ = [
    'DedupSpmmPlan', 'SpmmGraph', 'SpmmPlan', 'auto_chunk',
    'build_dedup_plan', 'build_spmm_graph', 'build_spmm_plan',
    'dedup_plan_apply', 'dedup_sum', 'dedup_sum_plain', 'estimate_dedup',
    'quantize_columns', 'spmm', 'spmm_chunked', 'spmm_chunked_plain',
    'spmm_plan_apply',
]
