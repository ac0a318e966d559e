"""Device ops of the port: planned SpMM over chunked and dedup plans, the
CSR segment family, and exact max/min."""

from pyg_lib_tpu_torch.ops.kernels.segment_csr import (segment_sum_csr_kernel,
                                                       segment_sum_csr_plain)
from pyg_lib_tpu_torch.ops.kernels.segment_minmax import (segment_max_kernel,
                                                          segment_max_plain)
from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import (
    SpmmPlan, auto_chunk, build_spmm_plan, quantize_columns, spmm_chunked,
    spmm_chunked_plain, spmm_plan_apply)
from pyg_lib_tpu_torch.ops.kernels.spmm_dedup import (DedupSpmmPlan,
                                                      build_dedup_plan,
                                                      dedup_plan_apply,
                                                      dedup_sum,
                                                      dedup_sum_plain,
                                                      estimate_dedup)
from pyg_lib_tpu_torch.ops.kernels.spmm_dedup_minmax import (
    DedupMinmaxPlan, build_dedup_minmax_plan, dedup_minmax,
    dedup_minmax_apply, dedup_minmax_plain, dedup_pairs,
    estimate_minmax_config)
from pyg_lib_tpu_torch.ops.segment_csr import (gather_csr, segment_add_csr,
                                               segment_csr, segment_max_csr,
                                               segment_mean_csr,
                                               segment_min_csr,
                                               segment_sum_csr)
from pyg_lib_tpu_torch.ops.spmm import (SpmmGraph, build_spmm_graph,
                                        segment_max_padded,
                                        segment_min_padded, spmm)

__all__ = [
    'DedupMinmaxPlan', 'DedupSpmmPlan', 'SpmmGraph', 'SpmmPlan',
    'auto_chunk', 'build_dedup_minmax_plan', 'build_dedup_plan',
    'build_spmm_graph', 'build_spmm_plan', 'dedup_minmax',
    'dedup_minmax_apply', 'dedup_minmax_plain', 'dedup_pairs',
    'dedup_plan_apply', 'dedup_sum', 'dedup_sum_plain', 'estimate_dedup',
    'estimate_minmax_config', 'gather_csr', 'quantize_columns',
    'segment_add_csr', 'segment_csr', 'segment_max_csr',
    'segment_max_kernel', 'segment_max_padded', 'segment_max_plain',
    'segment_mean_csr', 'segment_min_csr', 'segment_min_padded',
    'segment_sum_csr', 'segment_sum_csr_kernel', 'segment_sum_csr_plain',
    'spmm', 'spmm_chunked', 'spmm_chunked_plain', 'spmm_plan_apply',
]
