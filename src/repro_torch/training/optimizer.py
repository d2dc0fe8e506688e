"""AdamW and its learning-rate schedules (port of
``repro.training.optimizer``).

The parameters are a dict of named tensors (a module's
``named_parameters()``, gradients on); the state is ``{"m": {name:
float32}, "v": {name: float32}, "step": 0-d int32}`` on the parameters'
device.  :func:`apply_updates` updates the parameters and the moments in
place (the reference returns new arrays; in place saves a copy of every
parameter), with the reference's float32 arithmetic: global-norm clipping,
bias correction and decoupled weight decay.

Weight decay follows the reference's rule as it acts on the reference's
tree: a leaf decays when it has at least two dims *there*
(``p.ndim >= 2``).  The reference stacks each segment's per-layer leaves
on a layer axis, so every per-layer norm scale and bias decays, and only
the top-level vectors do not (``final_norm``, the encoder's ``norm``,
``time_mlp.*.b``, ``eps_head.b``).  The port keeps layers unstacked, so
:func:`decays` decides by the leaf's shape in the reference's tree
(ROADMAP queue 3, "Mirrored").
"""

from __future__ import annotations

import dataclasses
import functools
import math
import operator

import torch

Tensor = torch.Tensor

#: prefixes of the port's parameter names whose reference leaf is stacked
#: on a leading layer axis (the block stack and whisper's encoder layers)
STACKED_PREFIXES = ("backbone.layers.", "encoder.layers.")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # cosine | linear | constant


def lr_at(cfg: OptimizerConfig, step) -> Tensor:
    """The learning rate at ``step`` (an int or an int tensor): linear
    warmup over ``warmup_steps``, then cosine or linear decay to 0 at
    ``total_steps``, or constant; a float32 0-d tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    return cfg.lr * warm * decay


def decays(name: str, p: Tensor) -> bool:
    """Does the leaf ``name`` decay?  The reference's ``p.ndim >= 2`` on
    the leaf's shape in its tree, where the layers' leaves carry a layer
    axis."""
    return p.dim() >= 2 or name.startswith(STACKED_PREFIXES)


def init_state(params: dict) -> dict:
    """Zero float32 moments for every parameter, and step 0."""
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    device = next(iter(params.values())).device
    return {"m": zeros, "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tensors) -> Tensor:
    """sqrt of the sum of squares of every tensor, in float32 (summed from
    the first term, not from 0: the same number, and a partitioned
    gradient's share stays a share until the one reduction the sqrt
    needs)."""
    return torch.sqrt(functools.reduce(
        operator.add, (torch.sum(torch.square(x.to(torch.float32))) for x in tensors)))


@torch.no_grad()
def apply_updates(
    cfg: OptimizerConfig, params: dict, grads: dict, state: dict
) -> tuple[dict, dict, dict]:
    """One AdamW step, in place on ``params`` and ``state``'s moments.
    ``grads`` maps each parameter's name to its gradient; :func:`decays`
    says which parameters decay.  The update runs as ``torch._foreach_*``
    ops over groups of at most ``GROUP_ELEMENTS`` elements that share the
    decay flag (a few launches a group, not ten a tensor; the group bounds
    the float32 temporaries).  Returns (params, state, {"grad_norm"
    (before clipping), "lr"}), the metrics as 0-d tensors."""
    step = state["step"] + 1
    gnorm = global_norm(grads[n] for n in params)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    b1, b2 = cfg.betas
    lr = lr_at(cfg, step).to(gnorm.device)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    for decay, names in _groups(cfg, params):
        ps = [params[n] for n in names]
        p32 = [p.to(torch.float32) for p in ps]
        ms, vs = [state["m"][n] for n in names], [state["v"][n] for n in names]
        g = torch._foreach_mul([grads[n].to(torch.float32) for n in names], scale)
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, g, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, g, g, value=1 - b2)
        den = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        delta = torch._foreach_div(ms, bc1)
        torch._foreach_div_(delta, den)
        if decay:
            torch._foreach_add_(delta, p32, alpha=cfg.weight_decay)
        torch._foreach_mul_(delta, lr)
        torch._foreach_sub_(p32, delta)
        for p, q in zip(ps, p32):
            if q is not p:
                p.copy_(q)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


#: the most elements one group of :func:`apply_updates` holds (its three
#: float32 temporaries then take at most 768 MiB)
GROUP_ELEMENTS = 1 << 26


def _groups(cfg: OptimizerConfig, params: dict):
    """(decays, names) groups of the parameters, in order, each of at most
    ``GROUP_ELEMENTS`` elements unless one tensor alone is larger."""
    for decay in (True, False):
        names = [n for n, p in params.items()
                 if (bool(cfg.weight_decay) and decays(n, p)) == decay]
        group, size = [], 0
        for n in names:
            if group and size + params[n].numel() > GROUP_ELEMENTS:
                yield decay, group
                group, size = [], 0
            group.append(n)
            size += params[n].numel()
        if group:
            yield decay, group
