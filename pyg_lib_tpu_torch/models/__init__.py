"""GNN models of the port."""

from pyg_lib_tpu_torch.models.gnn import (GAT, GCN, SAGE, GATBatch,
                                          gat_batch_params_from_jax,
                                          gat_forward, gat_forward_spmm,
                                          gat_params_from_jax, gcn_forward,
                                          gcn_forward_spmm,
                                          gcn_params_from_jax, sage_forward,
                                          sage_maxpool_forward_spmm,
                                          sage_params_from_jax)

__all__ = ['GAT', 'GATBatch', 'GCN', 'SAGE', 'gat_batch_params_from_jax',
           'gat_forward', 'gat_forward_spmm', 'gat_params_from_jax',
           'gcn_forward', 'gcn_forward_spmm', 'gcn_params_from_jax',
           'sage_forward', 'sage_maxpool_forward_spmm',
           'sage_params_from_jax']
