"""Shared helpers for the port's device ops."""

from typing import Optional, Union

import torch

Array = torch.Tensor

__all__ = ['Array']


def _resolve_device(device: Optional[Union[str, torch.device]]
                    ) -> torch.device:
    """The device an entry point puts its tensors on.

    ``None`` means the CUDA card; without one this raises rather than
    carrying on on the CPU. Callers that want the CPU (the tests) say so.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                'the plain PyTorch versions on the CPU')
        return torch.device('cuda')
    return torch.device(device)
