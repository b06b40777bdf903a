"""Entropic-OT Sinkhorn solver, batched: counterpart of
``clip_ebc_tpu/losses/sinkhorn.py`` (``sinkhorn``, ``sinkhorn_separable``).

Plain (non-log) Sinkhorn-Knopp scaling with M_EPS division guards, fp32
throughout, a NaN/Inf bail-out that keeps the previous iterates, and a
convergence check on the source marginal every ``eval_freq`` iterations.

The JAX package solves one image with a ``lax.while_loop`` and ``vmap``s
it over the batch. Here the batch is a leading dimension and every image
carries a ``done`` flag: an image stops (its iterates, error and
iteration count freeze) exactly where its own JAX loop would stop, while
the others go on. The loop ends at ``max_iters`` or once every image is
done; that is read on the host only at the iterations where the marginal
check runs (every ``eval_freq``), never per iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

M_EPS = 1e-16


class SinkhornResult(NamedTuple):
    plan: torch.Tensor  # (B, na, nb) transport plan, or empty
    u: torch.Tensor  # (B, na) scaling
    v: torch.Tensor  # (B, nb) scaling
    alpha: torch.Tensor  # (B, na) dual potential reg*log(u)
    beta: torch.Tensor  # (B, nb) dual potential reg*log(v)
    err: torch.Tensor  # (B,) final marginal error
    iters: torch.Tensor  # (B,) iterations executed


def _masked_u0(a_mask: Optional[torch.Tensor], shape, device) -> torch.Tensor:
    """u starts at 1/n over the valid rows of each image."""
    if a_mask is None:
        return torch.full(shape, 1.0 / shape[1], dtype=torch.float32, device=device)
    n_valid = a_mask.float().sum(1, keepdim=True).clamp_min(1.0)
    return torch.where(a_mask, 1.0 / n_valid, torch.zeros((), device=device))


def _per_image(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], -1)


def _scaling_loop(
    a: torch.Tensor,
    b: torch.Tensor,
    KT_u: Callable[[torch.Tensor], torch.Tensor],
    K_v: Callable[[torch.Tensor], torch.Tensor],
    u: torch.Tensor,
    v: torch.Tensor,
    max_iters: int,
    stop_thr: float,
    eval_freq: int,
):
    """The shared scaling iteration over a batch; ``v``/``b`` may be any
    per-image shape (the separable solver keeps them (B, H, W))."""
    n = a.shape[0]
    dev = a.device
    err = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    iters = torch.zeros((n,), dtype=torch.int32, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    vshape = (n,) + (1,) * (v.dim() - 1)
    for it in range(1, max_iters + 1):
        v_new = b / (KT_u(u) + M_EPS)
        u_new = a / (K_v(v_new) + M_EPS)
        bad = ~(torch.isfinite(u_new).all(1) & torch.isfinite(_per_image(v_new)).all(1))
        step = ~done & ~bad  # images that take this iteration's iterates
        u = torch.where(step[:, None], u_new, u)
        v = torch.where(step.reshape(vshape), v_new, v)
        iters = iters + (~done).int()
        if it % eval_freq == 0:
            b_hat = KT_u(u) * v
            err = torch.where(step, _per_image((b - b_hat) ** 2).sum(1), err)
        done = done | bad | (err <= stop_thr)
        if it % eval_freq == 0 and bool(done.all()):
            break
    return u, v, err, iters


def sinkhorn(
    a: torch.Tensor,  # (B, na)
    b: torch.Tensor,  # (B, nb)
    cost: torch.Tensor,  # (B, na, nb)
    reg: float = 10.0,
    max_iters: int = 100,
    stop_thr: float = 1e-9,
    eval_freq: int = 10,
    a_mask: Optional[torch.Tensor] = None,  # (B, na) bool
    return_plan: bool = True,
) -> SinkhornResult:
    """Entropic OT between histograms ``a`` and ``b`` of each image;
    masked rows of ``a``/``cost`` behave as absent (zero kernel row,
    scaling 0). fp32 whatever the input dtypes."""
    a, b, cost = a.float(), b.float(), cost.float()
    n, na, nb = cost.shape
    K = torch.exp(-cost / reg)
    if a_mask is not None:
        K = torch.where(a_mask[:, :, None], K, 0.0)
        a = torch.where(a_mask, a, 0.0)
    u0 = _masked_u0(a_mask, (n, na), a.device)
    v0 = torch.full((n, nb), 1.0 / nb, dtype=torch.float32, device=a.device)
    u, v, err, iters = _scaling_loop(
        a, b,
        lambda u_: (u_[:, None, :] @ K)[:, 0],
        lambda v_: (K @ v_[:, :, None])[:, :, 0],
        u0, v0, max_iters, stop_thr, eval_freq,
    )
    alpha = reg * torch.log(u + M_EPS)
    beta = reg * torch.log(v + M_EPS)
    plan = u[:, :, None] * K * v[:, None, :] if return_plan else torch.zeros((n, 0, 0), device=a.device)
    return SinkhornResult(plan, u, v, alpha, beta, err, iters)


def sinkhorn_separable(
    a: torch.Tensor,  # (B, na)
    b: torch.Tensor,  # (B, H, W)
    ky: torch.Tensor,  # (B, na, H)
    kx: torch.Tensor,  # (B, na, W)
    reg: float = 10.0,
    max_iters: int = 100,
    stop_thr: float = 1e-9,
    eval_freq: int = 10,
    a_mask: Optional[torch.Tensor] = None,  # (B, na) bool
    return_plan: bool = False,
) -> SinkhornResult:
    """:func:`sinkhorn` for a separable cost on a 2-D grid, ``K = ky (x)
    kx`` per image: each matvec is two small batched products over the
    factors instead of one over the dense (na, H*W) kernel. ``v``/``beta``
    come back flattened row-major (y-major), as the dense solver's."""
    a, b2, ky, kx = a.float(), b.float(), ky.float(), kx.float()
    n, na, h = ky.shape
    w = kx.shape[2]
    if a_mask is not None:
        ky = torch.where(a_mask[:, :, None], ky, 0.0)
        a = torch.where(a_mask, a, 0.0)
    u0 = _masked_u0(a_mask, (n, na), a.device)
    v0 = torch.full((n, h, w), 1.0 / (h * w), dtype=torch.float32, device=a.device)

    def KT_u(u):  # (B, na) -> (B, H, W)
        return (u[:, :, None] * ky).transpose(1, 2) @ kx

    def K_v(v2):  # (B, H, W) -> (B, na)
        return (ky * (kx @ v2.transpose(1, 2))).sum(2)

    u, v2, err, iters = _scaling_loop(a, b2, KT_u, K_v, u0, v0, max_iters, stop_thr, eval_freq)
    v = v2.reshape(n, h * w)
    alpha = reg * torch.log(u + M_EPS)
    beta = reg * torch.log(v + M_EPS)
    if return_plan:
        K = (ky[:, :, :, None] * kx[:, :, None, :]).reshape(n, na, h * w)
        plan = u[:, :, None] * K * v[:, None, :]
    else:
        plan = torch.zeros((n, 0, 0), device=a.device)
    return SinkhornResult(plan, u, v, alpha, beta, err, iters)
