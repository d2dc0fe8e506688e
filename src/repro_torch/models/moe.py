"""Mixture-of-Experts FFN (port of ``repro.models.moe``): Mixtral's top-2
and DeepSeek's fine-grained top-6 with shared experts.

Dispatch strategies (``cfg.moe.dispatch``):

* ``dropping`` (default) — capacity dispatch per token group, as the
  reference does it: each row of ``S`` tokens is cut into groups of
  ``g = min(dispatch_group, S)`` tokens (the whole row when ``g`` does not
  divide it); an expert takes at most ``cap = max(int(g * k / E *
  capacity_factor), 1)`` of a group's assignments, in token order, and the
  rest are dropped (their residual passes through).  ``cap`` comes from
  the padded length, as in the reference, so right-padding a row changes
  which of its assignments fit (ROADMAP queue 3).
* ``dense_mix`` — every expert on every token, mixed by the router's
  weights: the correctness oracle of the tests.

On the card every step is a plain tensor op whose shapes come from the
config and the input's shape: the rank of an assignment within its expert
is a cumulative sum over an (E, S·k) membership table (the reference's
stable ``argsort`` / ``searchsorted`` rank, with no sort), the tokens are
copied into one (E·G·cap + 1, d) buffer whose last row takes the
overflow, the experts run as batched matrix products over (E, G·cap, d),
and a token's k outputs, which sit at ``tok·k .. tok·k + k - 1``, are
summed by a reshape (no atomics, so a replay is bitwise its eager run).
Nothing reads a value back to the host, so the forward can be captured
in a CUDA graph.

The router's weight stays float32 and its math runs in float32 (bf16
routers destabilize top-k), as in the reference.

A token's output does not depend on the rows beside it (the reference's
determinism contract, ``docs/serving.md``): the router is a ``Linear``
(the row-invariant GEMM, float32), the experts' products are
:func:`~repro_torch.kernels.gemm.bgemm` (G = E; a token's row in its
expert's buffer meets the same weights at any G·cap), and the two sums
over k (the top-k renormalisation and a token's k outputs) are folds in
index order (:func:`fold_sum`).  ``meta`` tensors keep ``torch.bmm`` and
``sum``, which the dry run counts.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.gemm import bgemm
from repro_torch.models import layers as L

Tensor = torch.Tensor


def fold_sum(t: Tensor, dim: int) -> Tensor:
    """``t.sum(dim)``, as PyTorch sums it (in float32, rounded once to
    t's dtype), but added in index order by elementwise ops: PyTorch's
    reduce kernel splits a sum by the tensor's shape, so a row's sum could
    depend on the rows beside it.  For the short sums over k (k <= 6).
    ``meta`` tensors keep ``sum``."""
    if t.device.type == "meta":
        return t.sum(dim=dim)
    parts = t.unbind(dim)
    acc = parts[0].to(torch.float32, copy=True)
    for part in parts[1:]:
        acc.add_(part)
    return acc.to(t.dtype)


@dataclasses.dataclass
class Plan:
    """The routing of one dispatch: per group of ``g`` tokens, each token's
    top-k ``ids`` and renormalized ``weights`` (G, g, k), the rank of each
    assignment within its expert and whether it fits the capacity (G, g·k),
    and the capacity ``cap``."""

    weights: Tensor
    ids: Tensor
    rank: Tensor
    keep: Tensor
    cap: int
    aux: dict


class Experts(nn.Module):
    """The routed experts' stacked SwiGLU weights: ``wi``, ``wg`` (E, d, f)
    and ``wo`` (E, f, d), in the reference's layout."""

    def __init__(self, e: int, d: int, ff: int, *, generator, device, dtype):
        super().__init__()
        for name, shape in (("wi", (e, d, ff)), ("wg", (e, d, ff)),
                            ("wo", (e, ff, d))):
            self.register_parameter(name, nn.Parameter(
                L.init_tensor(shape, "fan_in", generator, device, dtype),
                requires_grad=False))

    def forward(self, xs: Tensor) -> Tensor:
        """xs: (E, C, d) -> (E, C, d), one batched product per weight
        (:func:`~repro_torch.kernels.gemm.bgemm`; ``torch.bmm`` on
        ``meta``)."""
        bmm = torch.bmm if xs.device.type == "meta" else bgemm
        h = (F.silu(bmm(xs, self.wg.to(xs.dtype)))
             * bmm(xs, self.wi.to(xs.dtype)))
        return bmm(h, self.wo.to(xs.dtype))


class MoE(nn.Module):
    """Router + routed experts (+ shared experts); ``forward`` returns the
    output and the aux losses ``{"moe_aux", "moe_z"}`` like the
    reference's ``moe_ffn``."""

    def __init__(self, cfg, *, generator, device, dtype):
        super().__init__()
        m = cfg.moe
        d = cfg.d_model
        self.cfg = cfg
        self.router = L.Linear(d, m.num_experts, generator=generator,
                               device=device, dtype=torch.float32)
        self.experts = Experts(m.num_experts, d, m.d_ff_expert,
                               generator=generator, device=device, dtype=dtype)
        self.shared = (
            L.MLP(d, m.d_ff_expert * m.num_shared, "silu",
                  generator=generator, device=device, dtype=dtype)
            if m.num_shared else None
        )

    # ---- routing ----
    def route(self, x: Tensor, token_dims: tuple[int, ...]):
        """Top-k routing of ``x`` (..., d) in float32: (weights, ids) of
        shape (..., k) and the aux losses averaged over ``token_dims``."""
        m = self.cfg.moe
        logits = self.router(x.to(torch.float32))
        probs = torch.softmax(logits, dim=-1)
        weights, ids = torch.topk(probs, m.top_k, dim=-1)
        weights = weights / fold_sum(weights, -1)[..., None]
        experts = torch.arange(m.num_experts, device=x.device)
        member = (ids[..., None] == experts).to(torch.float32)  # (..., k, E)
        density = member.sum(dim=-2).mean(dim=token_dims) / m.top_k
        mean_prob = probs.mean(dim=token_dims)
        aux = {
            "moe_aux": m.num_experts * (density * mean_prob).sum(dim=-1),
            "moe_z": (torch.logsumexp(logits, dim=-1) ** 2).mean(dim=token_dims),
        }
        return weights, ids, aux

    def plan(self, xg: Tensor) -> Plan:
        """Routing and capacity of token groups ``xg`` (G, g, d)."""
        m = self.cfg.moe
        ng, g, _ = xg.shape
        k, e = m.top_k, m.num_experts
        cap = max(int(g * k / e * m.capacity_factor), 1)
        weights, ids, aux = self.route(xg, token_dims=(1,))
        flat_e = ids.reshape(ng, g * k)
        # rank of each assignment within its expert, stable by token order:
        # the inclusive count of earlier assignments to the same expert, a
        # scan along the innermost (assignment) axis of an (E, S·k) table
        member = torch.arange(e, device=xg.device)[:, None] == flat_e[:, None, :]
        counts = torch.cumsum(member.to(torch.int32), dim=2, dtype=torch.int32)
        rank = torch.gather(counts, 1, flat_e[:, None, :])[:, 0] - 1
        aux = {name: v.mean() for name, v in aux.items()}
        return Plan(weights, ids, rank, rank < cap, cap, aux)

    # ---- dispatch ----
    def _dropping(self, x: Tensor) -> tuple[Tensor, dict]:
        m = self.cfg.moe
        b, s, d = x.shape
        g = min(m.dispatch_group, s)
        g = g if s % g == 0 else s
        ng = b * (s // g)
        k, e = m.top_k, m.num_experts
        xg = x.reshape(ng, g, d)
        p = self.plan(xg)
        cap = p.cap
        flat_e = p.ids.reshape(ng, g * k)
        group = torch.arange(ng, device=x.device)[:, None]
        # row of each kept assignment in the (E, G, cap) buffer; dropped
        # ones go to the one overflow row past its end, which no expert reads
        row = (flat_e * ng + group) * cap + p.rank.clamp(max=cap - 1)
        dump = e * ng * cap
        dst = row.masked_fill(~p.keep, dump)
        buf = x.new_zeros(dump + 1, d)
        src = xg.repeat_interleave(k, dim=1).reshape(ng * g * k, d)
        buf.index_copy_(0, dst.reshape(-1), src)
        out_buf = self.experts(buf[:dump].view(e, ng * cap, d))
        gathered = out_buf.reshape(dump, d).index_select(0, row.reshape(-1))
        scale = (p.keep.to(x.dtype) * p.weights.reshape(ng, g * k).to(x.dtype))
        gathered = gathered * scale.reshape(-1, 1)
        out = fold_sum(gathered.view(ng, g, k, d), 2)
        return out.reshape(b, s, d), p.aux

    def _dense_mix(self, x: Tensor) -> tuple[Tensor, dict]:
        """Every expert on every token, mixed by the top-k weights."""
        m = self.cfg.moe
        e, d = m.num_experts, x.shape[-1]
        weights, ids, aux = self.route(x, token_dims=tuple(range(x.dim() - 1)))
        n = x.numel() // d
        outs = self.experts(x.reshape(1, n, d).expand(e, n, d))   # (E, N, d)
        outs = outs.reshape((e,) + x.shape).movedim(0, -2)        # (..., E, d)
        sel = torch.gather(outs, -2, ids[..., None].expand(*ids.shape, d))
        return (sel * weights[..., None].to(x.dtype)).sum(dim=-2), aux

    def forward(self, x: Tensor) -> tuple[Tensor, dict]:
        """x: (B, S, d) -> (B, S, d), plus the aux losses."""
        dispatch = self.cfg.moe.dispatch
        if dispatch == "dropping":
            out, aux = self._dropping(x)
        elif dispatch == "dense_mix":
            out, aux = self._dense_mix(x)
        else:
            raise ValueError(f"unknown MoE dispatch {dispatch!r}")
        if self.shared is not None:
            out = out + self.shared(x)
        return out, aux
