"""Lagrange predictor and error-robust selection (port of ``repro.core.lagrange``).

The reference computes one row and ``vmap``s it over the batch; here every
function takes leading batch dimensions directly: node times ``(..., k)``,
an error power ``(...)``, and selections ``(..., k)``.  The step index
``i`` is a host integer (the port's solver loop runs on the host), so the
selections stay on the device with no host sync.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def lagrange_weights(t_nodes: Tensor, t_eval) -> Tensor:
    """Weights l_m(t_eval) for nodes ``t_nodes`` (..., k) (paper Eq. 13):
    l_m(t) = prod_{l != m} (t - t_l) / (t_m - t_l)."""
    k = t_nodes.shape[-1]
    t_nodes = t_nodes.to(torch.float32)
    t_eval = torch.as_tensor(t_eval, dtype=torch.float32, device=t_nodes.device)
    diff = t_nodes[..., :, None] - t_nodes[..., None, :]      # (..., k, k)
    num = t_eval[..., None] - t_nodes                         # (..., k)
    eye = torch.eye(k, dtype=torch.bool, device=t_nodes.device)
    one = torch.ones((), dtype=torch.float32, device=t_nodes.device)
    ratio = torch.where(
        eye, one, num[..., None, :] / torch.where(eye, one, diff)
    )
    return torch.prod(ratio, dim=-1)


def interpolate(eps_nodes: Tensor, t_nodes: Tensor, t_eval) -> Tensor:
    """L_eps(t_eval) = sum_m l_m(t_eval) * eps_m for one set of nodes:
    ``eps_nodes`` (k, ...), ``t_nodes`` (k,)."""
    w = lagrange_weights(t_nodes, t_eval).to(eps_nodes.dtype)
    return torch.tensordot(w, eps_nodes, dims=([0], [0]))


def _dedup_increasing(tau: list[Tensor], i: int, k: int) -> Tensor:
    """Force the k selections strictly increasing within [0, i]."""
    out = []
    prev = torch.full_like(tau[0], -1)
    for m in range(k):
        cur = torch.maximum(tau[m], prev + 1)
        out.append(cur)
        prev = cur
    # backward clamp so the last index can still be <= i
    fixed = []
    nxt = torch.full_like(tau[0], i + 1)
    for m in reversed(range(k)):
        cur = torch.minimum(out[m], nxt - 1)
        fixed.append(cur)
        nxt = cur
    fixed.reverse()
    return torch.stack([torch.clamp(c, min=0) for c in fixed], dim=-1)


def ers_select(i: int, k: int, power: Tensor) -> Tensor:
    """Error-robust selection (Eq. 16/17): tau_m = floor((m/k)^power * i),
    deduplicated.  ``power`` (...) -> int32 selections (..., k)."""
    power = torch.as_tensor(power, dtype=torch.float32)
    taus = []
    for m in range(1, k + 1):
        # the base stays a host scalar, cast to float32 inside the kernel:
        # no host-to-device copy, so a CUDA graph can capture the step
        taus.append(torch.floor((m / k) ** power * float(i)).to(torch.int32))
    return _dedup_increasing(taus, i, k)


def fixed_select(i: int, k: int, device=None) -> Tensor:
    """Fixed strategy: the last k entries (tau_m = i - (k-1) + m)."""
    return torch.arange(
        i - (k - 1), i + 1, dtype=torch.int32, device=device
    )


def select_bases(
    i: int, k: int, delta_eps: Tensor, lam: float, strategy: str,
    const_power: float | None = None,
) -> Tensor:
    """Selections (..., k) for errors ``delta_eps`` (...)."""
    if strategy == "fixed":
        return fixed_select(i, k, delta_eps.device).expand(
            delta_eps.shape + (k,)
        )
    if strategy == "ers":
        return ers_select(i, k, delta_eps / lam)
    if strategy == "const":
        # ablation: a constant power in place of delta_eps / lambda
        if const_power is None:
            raise ValueError("selection 'const' needs const_power")
        return ers_select(
            i, k, torch.full_like(delta_eps, const_power, dtype=torch.float32)
        )
    raise ValueError(f"unknown selection strategy {strategy!r}")
