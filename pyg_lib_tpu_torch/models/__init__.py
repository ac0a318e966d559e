"""GNN models of the port."""

from pyg_lib_tpu_torch.models.gnn import (GCN, gcn_forward_spmm,
                                          gcn_params_from_jax)

__all__ = ['GCN', 'gcn_forward_spmm', 'gcn_params_from_jax']
