"""Runnable examples of the port (``python -m
pyg_lib_tpu_torch.examples.<name>``)."""
