"""Device ops of the port: planned SpMM over chunked, dedup and
range-split plans (and ``spmm_csr`` over a cached plan, ``spmm_sharded``
over row-split plans), the CSR segment
family, exact max/min, the attention primitives (``softmax_csr``, the
padded-space softmax and sum, ``sddmm``), the scatter and sorted-COO
families, the scatter composites, ``fused_scatter_reduce``, the
segment/grouped matmul, the sampled binary ops, ``index_sort``, the
SplineCNN basis and weighting, and the point-cloud and clustering ops
(``fps`` over kernel F1, ``knn``, ``radius``, ``nearest``,
``grid_cluster``, ``graclus_cluster``, ``edge_sample``)."""

from pyg_lib_tpu_torch.ops.composite import (scatter_log_softmax,
                                             scatter_logsumexp,
                                             scatter_softmax, scatter_std)
from pyg_lib_tpu_torch.ops.geometry import (edge_sample, fps,
                                            graclus_cluster, grid_cluster,
                                            knn, nearest, radius)
from pyg_lib_tpu_torch.ops.index_sort import index_sort
from pyg_lib_tpu_torch.ops.kernels.fps import fps_kernel, fps_plain
from pyg_lib_tpu_torch.ops.kernels.segment_csr import (segment_sum_csr_kernel,
                                                       segment_sum_csr_plain)
from pyg_lib_tpu_torch.ops.kernels.segment_minmax import (segment_max_kernel,
                                                          segment_max_plain)
from pyg_lib_tpu_torch.ops.kernels.segment_softmax import (
    segment_softmax_plain, segment_softmax_planned)
from pyg_lib_tpu_torch.ops.kernels.spmm_chunked import (
    SpmmPlan, auto_chunk, build_spmm_plan, quantize_columns,
    segment_sum_chunked, segment_sum_chunked_plain, spmm_chunked,
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
from pyg_lib_tpu_torch.ops.kernels.spmm_range_fused import (
    FusedRangePlan, build_fused_range_plan, fused_range_apply,
    fused_range_plain, fused_range_sum)
from pyg_lib_tpu_torch.ops.matmul import grouped_matmul, segment_matmul
from pyg_lib_tpu_torch.ops.sampled import (sampled_add, sampled_div,
                                           sampled_mul, sampled_sub)
from pyg_lib_tpu_torch.ops.scatter import (scatter, scatter_add,
                                           scatter_max, scatter_mean,
                                           scatter_min, scatter_mul,
                                           scatter_sum)
from pyg_lib_tpu_torch.ops.scatter_reduce import fused_scatter_reduce
from pyg_lib_tpu_torch.ops.segment_coo import (gather_coo, segment_add_coo,
                                               segment_coo, segment_max_coo,
                                               segment_mean_coo,
                                               segment_min_coo,
                                               segment_sum_coo)
from pyg_lib_tpu_torch.ops.segment_csr import (gather_csr, segment_add_csr,
                                               segment_csr, segment_max_csr,
                                               segment_mean_csr,
                                               segment_min_csr,
                                               segment_sum_csr)
from pyg_lib_tpu_torch.ops.softmax import softmax_csr
from pyg_lib_tpu_torch.ops.spline import spline_basis, spline_weighting
from pyg_lib_tpu_torch.ops.spmm import (RangeSpmmPlan, ShardedSpmmGraph,
                                        SpmmGraph, build_spmm_graph,
                                        build_spmm_graph_sharded,
                                        build_weighted_fused_graph, sddmm,
                                        segment_max_padded,
                                        segment_min_padded,
                                        segment_softmax_padded,
                                        segment_sum_padded, spmm, spmm_csr,
                                        spmm_sharded)

__all__ = [
    'DedupMinmaxPlan', 'DedupSpmmPlan', 'FusedRangePlan', 'RangeSpmmPlan',
    'ShardedSpmmGraph', 'SpmmGraph', 'SpmmPlan', 'auto_chunk',
    'build_dedup_minmax_plan', 'build_dedup_plan', 'build_fused_range_plan',
    'build_spmm_graph', 'build_spmm_graph_sharded', 'build_spmm_plan',
    'build_weighted_fused_graph', 'dedup_minmax', 'dedup_minmax_apply',
    'dedup_minmax_plain', 'dedup_pairs', 'dedup_plan_apply', 'dedup_sum',
    'dedup_sum_plain', 'edge_sample', 'estimate_dedup',
    'estimate_minmax_config', 'fps', 'fps_kernel', 'fps_plain',
    'fused_range_apply', 'fused_range_plain', 'fused_range_sum',
    'fused_scatter_reduce', 'gather_coo', 'gather_csr', 'graclus_cluster',
    'grid_cluster', 'grouped_matmul', 'index_sort', 'knn', 'nearest',
    'quantize_columns', 'radius', 'sampled_add', 'sampled_div', 'sampled_mul',
    'sampled_sub', 'scatter', 'scatter_add', 'scatter_log_softmax',
    'scatter_logsumexp', 'scatter_max', 'scatter_mean', 'scatter_min',
    'scatter_mul', 'scatter_softmax', 'scatter_std', 'scatter_sum', 'sddmm',
    'segment_add_coo', 'segment_add_csr', 'segment_coo', 'segment_csr',
    'segment_matmul', 'segment_max_coo', 'segment_max_csr',
    'segment_max_kernel', 'segment_max_padded', 'segment_max_plain',
    'segment_mean_coo', 'segment_mean_csr', 'segment_min_coo',
    'segment_min_csr', 'segment_min_padded', 'segment_softmax_padded',
    'segment_softmax_plain', 'segment_softmax_planned', 'segment_sum_chunked',
    'segment_sum_chunked_plain', 'segment_sum_coo', 'segment_sum_csr',
    'segment_sum_csr_kernel', 'segment_sum_csr_plain', 'segment_sum_padded',
    'softmax_csr', 'spline_basis', 'spline_weighting', 'spmm', 'spmm_chunked',
    'spmm_chunked_plain', 'spmm_csr', 'spmm_plan_apply', 'spmm_sharded',
]
