"""GNN models of the port."""

from pyg_lib_tpu_torch.models.gnn import (
    GAT, GCN, RGCN, SAGE, GATBatch, HeteroSpmmPlan, RGCNBatch,
    build_rgcn_graphs, build_rgcn_planned, gat_batch_params_from_jax,
    gat_forward, gat_forward_spmm, gat_params_from_jax, gcn_forward,
    gcn_forward_spmm, gcn_params_from_jax, init_rgcn, init_rgcn_spmm,
    rgcn_forward, rgcn_forward_planned, rgcn_forward_spmm,
    rgcn_params_from_jax, rgcn_spmm_params_from_jax, sage_forward,
    sage_maxpool_forward_spmm, sage_params_from_jax)

__all__ = ['GAT', 'GATBatch', 'GCN', 'HeteroSpmmPlan', 'RGCN', 'RGCNBatch',
           'SAGE', 'build_rgcn_graphs', 'build_rgcn_planned',
           'gat_batch_params_from_jax', 'gat_forward', 'gat_forward_spmm',
           'gat_params_from_jax', 'gcn_forward', 'gcn_forward_spmm',
           'gcn_params_from_jax', 'init_rgcn', 'init_rgcn_spmm',
           'rgcn_forward', 'rgcn_forward_planned', 'rgcn_forward_spmm',
           'rgcn_params_from_jax', 'rgcn_spmm_params_from_jax',
           'sage_forward', 'sage_maxpool_forward_spmm',
           'sage_params_from_jax']
