"""GNN models of the port: GCN, GraphSAGE, GAT and R-GCN
(``models.gnn``); GIN, EdgeConv, the PointNet++ set abstraction and
node2vec's loss (``models.extra``)."""

from pyg_lib_tpu_torch.models.extra import (
    GIN, EdgeConv, PointNetSA, edgeconv_forward, edgeconv_params_from_jax,
    gin_forward, gin_params_from_jax, init_edgeconv, init_gin,
    init_node2vec, init_pointnet_sa, node2vec_loss, node2vec_params_from_jax,
    pointnet_sa_forward, pointnet_sa_params_from_jax)
from pyg_lib_tpu_torch.models.gnn import (
    GAT, GCN, RGCN, SAGE, GATBatch, HeteroSpmmPlan, RGCNBatch,
    build_rgcn_graphs, build_rgcn_planned, gat_batch_params_from_jax,
    gat_forward, gat_forward_spmm, gat_params_from_jax, gcn_forward,
    gcn_forward_spmm, gcn_params_from_jax, init_gat, init_gat_spmm,
    init_gcn, init_rgcn, init_rgcn_spmm, init_sage, rgcn_forward,
    rgcn_forward_planned, rgcn_forward_spmm, rgcn_params_from_jax,
    rgcn_spmm_params_from_jax, sage_forward, sage_maxpool_forward_spmm,
    sage_params_from_jax)

__all__ = ['EdgeConv', 'GAT', 'GATBatch', 'GCN', 'GIN', 'HeteroSpmmPlan',
           'PointNetSA', 'RGCN', 'RGCNBatch', 'SAGE', 'build_rgcn_graphs',
           'build_rgcn_planned', 'edgeconv_forward',
           'edgeconv_params_from_jax', 'gat_batch_params_from_jax',
           'gat_forward', 'gat_forward_spmm', 'gat_params_from_jax',
           'gcn_forward', 'gcn_forward_spmm', 'gcn_params_from_jax',
           'gin_forward', 'gin_params_from_jax', 'init_edgeconv', 'init_gat',
           'init_gat_spmm', 'init_gcn', 'init_gin', 'init_node2vec',
           'init_pointnet_sa', 'init_rgcn', 'init_rgcn_spmm', 'init_sage',
           'node2vec_loss', 'node2vec_params_from_jax', 'pointnet_sa_forward',
           'pointnet_sa_params_from_jax', 'rgcn_forward',
           'rgcn_forward_planned', 'rgcn_forward_spmm', 'rgcn_params_from_jax',
           'rgcn_spmm_params_from_jax', 'sage_forward',
           'sage_maxpool_forward_spmm', 'sage_params_from_jax']
