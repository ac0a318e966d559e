"""SplineCNN B-spline basis and weighting (port of
``pyg_lib_tpu.ops.spline``).

``spline_basis`` is one gather and product over the static ``[S, D]``
table of base-``(degree + 1)`` digits, as in the JAX package. Gradients
come from autograd: ``frac = v - floor(v)`` has ``d frac / d v = 1``
(floor's gradient is 0), which is the reference's hand-written backward.

``spline_weighting`` computes ``out[e] = Σ_s basis[e, s] · (x[e] @
weight[weight_index[e, s]])`` without the ``[E, S, M_in, M_out]`` slab of
gathered weights that the JAX einsum builds: one ``torch.mm`` of ``x`` by
the weights laid out as ``[M_in, K·M_out]`` gives every edge's product
with all ``K`` kernel weights, and a gather takes the ``S`` blocks each
edge needs. The plain product stays ``torch.mm``, as the JAX package left
it to XLA.
"""

from typing import Tuple

import torch

__all__ = ['spline_basis', 'spline_weighting']


def _basis_closed_form(v: torch.Tensor, degree: int) -> torch.Tensor:
    """The ``degree + 1`` basis polynomials at ``v``: ``[..., p + 1]``."""
    if degree == 1:
        return torch.stack([1.0 - v, v], dim=-1)
    if degree == 2:
        return torch.stack([
            0.5 * v * v - v + 0.5,
            -v * v + v + 0.5,
            0.5 * v * v,
        ], dim=-1)
    if degree == 3:
        return torch.stack([
            (1.0 - v)**3 / 6.0,
            (3.0 * v**3 - 6.0 * v * v + 4.0) / 6.0,
            (-3.0 * v**3 + 3.0 * v * v + 3.0 * v + 1.0) / 6.0,
            v**3 / 6.0,
        ], dim=-1)
    raise ValueError(f'Basis degree {degree} not implemented')


def spline_basis(pseudo: torch.Tensor, kernel_size: torch.Tensor,
                 is_open_spline: torch.Tensor, degree: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B-spline bases and weight indices.

    Args:
        pseudo: ``[E, D]`` pseudo-coordinates in ``[0, 1]``.
        kernel_size: ``[D]`` integer kernel size per dimension.
        is_open_spline: ``[D]`` 0/1 per dimension.
        degree: B-spline degree (1-3).

    Returns:
        ``(basis [E, S], weight_index [E, S] int64)`` with
        ``S = (degree + 1)**D``.
    """
    d_num = pseudo.shape[1]
    dev = pseudo.device
    p1 = degree + 1
    s_num = p1**d_num
    kernel_size = torch.as_tensor(kernel_size, device=dev)
    is_open_spline = torch.as_tensor(is_open_spline, device=dev)
    # kmod[s, d] is the d-th base-(p + 1) digit of s.
    s_idx = torch.arange(s_num, device=dev)
    kmod = torch.stack([(s_idx // p1**d) % p1 for d in range(d_num)], dim=1)

    scale = (kernel_size.to(pseudo.dtype) -
             degree * is_open_spline.to(pseudo.dtype))
    v = pseudo * scale
    vfloor = torch.floor(v)
    frac = v - vfloor

    b_all = _basis_closed_form(frac, degree)  # [E, D, p + 1]
    dims = torch.arange(d_num, device=dev)
    basis = b_all[:, dims[None, :], kmod].prod(dim=-1)  # [E, S]

    ks = kernel_size.long()
    stride = torch.cat([torch.ones(1, dtype=torch.int64, device=dev),
                        torch.cumprod(ks, 0)[:-1]])
    wi_d = (vfloor.long()[:, None, :] + kmod) % ks  # [E, S, D]
    return basis, (wi_d * stride).sum(dim=-1)


def spline_weighting(x: torch.Tensor, weight: torch.Tensor,
                     basis: torch.Tensor,
                     weight_index: torch.Tensor) -> torch.Tensor:
    """``out[e] = Σ_s basis[e, s] · (x[e] @ weight[weight_index[e, s]])``
    for ``x [E, M_in]``, ``weight [K, M_in, M_out]``, ``basis`` and
    ``weight_index [E, S]``; returns ``[E, M_out]``."""
    k, m_in, m_out = weight.shape
    e, s = weight_index.shape
    y = torch.mm(x, weight.permute(1, 0, 2).reshape(m_in, k * m_out))
    picked = torch.gather(
        y.view(e, k, m_out), 1,
        weight_index.long()[:, :, None].expand(e, s, m_out))
    return torch.bmm(basis.to(y.dtype)[:, None, :], picked)[:, 0]
