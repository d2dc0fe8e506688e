"""Training loop (port of ``repro.training.train_loop``): the LM and
diffusion step builders and the host loop.

A step builder takes a module that owns its weights (a
:class:`repro_torch.models.Model` or :class:`repro_torch.models.
DiffusionLM`, built with ``param_dtype=torch.float32``), turns gradients on
for its parameters and returns ``step(opt_state, batch, generator) ->
(opt_state, metrics)``: a forward, ``backward()`` and one AdamW step that
updates the module's parameters in place.  The step carries the module
(``step.module``), its parameters by name (``step.params``) and its
optimizer config (``step.opt_cfg``).  Steps run eagerly; a batch is a
dict of tensors on the module's device.  On the card every attention of the
forward is the flash kernel and its backward the hand-written backward
kernel (:mod:`repro_torch.kernels.flash_attention`).

The reference draws each step's diffusion noise from a ``jax.random`` key
split off a seed; the port draws it from one ``torch.Generator`` seeded
with ``seed``, on the module's device (the numbers differ; the parity
tests feed the reference's draws to :meth:`DiffusionLM.loss_at`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.interop import (
    model_params_to_jax,
    opt_state_to_jax,
    params_to_jax,
)
from repro_torch.models.diffusion import DiffusionLM
from repro_torch.models.model import Model
from repro_torch.parallel.ctx import constrain_batch
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt

Tensor = torch.Tensor


def trainable(module: torch.nn.Module) -> dict:
    """The module's parameters by name, with gradients turned on."""
    params = dict(module.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


def _grads(params: dict) -> dict:
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in params.items()}


def _step_fn(module, params: dict, opt_cfg, fn: Callable) -> Callable:
    fn.module, fn.params, fn.opt_cfg = module, params, opt_cfg
    return fn


def make_lm_train_step(
    model: Model, opt_cfg: opt.OptimizerConfig, microbatches: int = 1
) -> Callable:
    """LM train step on ``model.loss``; ``microbatches > 1`` accumulates
    the gradients of equal slices of the batch (so long-sequence
    activations fit), then averages loss, aux and gradients, as the
    reference's scan over slices does."""
    params = trainable(model)

    def step(opt_state: dict, batch: dict, generator=None):
        del generator
        for p in params.values():
            p.grad = None
        if microbatches <= 1:
            loss, aux = model.loss(batch)
            loss.backward()
            loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
        else:
            n = next(iter(batch.values())).shape[0] // microbatches
            loss, aux = 0.0, None
            for i in range(microbatches):
                # the reference's microbatch sharding hint (a no-op here)
                sl = {k: constrain_batch(v[i * n : (i + 1) * n])
                      for k, v in batch.items()}
                l, a = model.loss(sl)
                l.backward()
                loss = loss + l.detach()
                a = {k: v.detach() for k, v in a.items()}
                aux = a if aux is None else {k: aux[k] + a[k] for k in aux}
            inv = 1.0 / microbatches
            loss = loss * inv
            aux = {k: v * inv for k, v in aux.items()}
            for p in params.values():
                if p.grad is not None:
                    p.grad.mul_(inv)
        _, opt_state, om = opt.apply_updates(opt_cfg, params, _grads(params),
                                             opt_state)
        return opt_state, {"loss": loss, **aux, **om}

    return _step_fn(model, params, opt_cfg, step)


def make_diffusion_train_step(
    dlm: DiffusionLM, opt_cfg: opt.OptimizerConfig, schedule
) -> Callable:
    """Diffusion train step on ``dlm.loss``: the batch's ``latents``, the
    time offset and the noise drawn from the step's ``generator``."""
    params = trainable(dlm)

    def step(opt_state: dict, batch: dict, generator: torch.Generator):
        for p in params.values():
            p.grad = None
        loss, aux = dlm.loss(batch, generator, schedule)
        loss.backward()
        _, opt_state, om = opt.apply_updates(opt_cfg, params, _grads(params),
                                             opt_state)
        return opt_state, {"loss": loss.detach(),
                           **{k: v.detach() for k, v in aux.items()}, **om}

    return _step_fn(dlm, params, opt_cfg, step)


@dataclasses.dataclass
class TrainResult:
    params: Any       # the module's parameters by name (updated in place)
    opt_state: Any
    history: list[dict]


def checkpoint_tree(module, params: dict, opt_state: dict) -> dict:
    """{"params", "opt"} keyed as the reference's trees, for
    :func:`repro_torch.training.checkpoint.save` (the reference's
    ``restore`` loads it)."""
    cfg = module.config
    denoiser = isinstance(module, DiffusionLM)
    to = params_to_jax if denoiser else model_params_to_jax
    return {"params": to(params, cfg),
            "opt": opt_state_to_jax(opt_state, cfg, denoiser)}


def batch_to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def train(
    step_fn: Callable,
    batches: Iterator[dict],
    num_steps: int,
    *,
    seed: int = 0,
    log_every: int = 10,
    ckpt_dir: str | None = None,
    ckpt_every: int = 200,
    to_device: Callable[[dict], dict] | None = None,
    print_fn: Callable[[str], None] = print,
) -> TrainResult:
    """Host loop: feed ``num_steps`` batches to ``step_fn``, keep the
    metrics at every ``log_every``-th step and the last (with ``step`` and
    ``wall_s``), print them, and checkpoint every ``ckpt_every`` steps and
    at the end (:func:`ckpt.save_rotating`).  Numpy batches go to the
    module's device unless ``to_device`` is given."""
    module, params = step_fn.module, step_fn.params
    device = next(iter(params.values())).device
    move = to_device or (lambda b: batch_to_device(b, device))
    opt_state = opt.init_state(params)
    gen = torch.Generator(device=device).manual_seed(seed)
    history = []
    t0 = time.perf_counter()
    for i in range(num_steps):
        batch = move(next(batches))
        opt_state, metrics = step_fn(opt_state, batch, gen)
        if i % log_every == 0 or i == num_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i
            m["wall_s"] = round(time.perf_counter() - t0, 2)
            history.append(m)
            print_fn(
                f"step {i:5d} loss {m.get('loss', float('nan')):.4f} "
                f"lr {m.get('lr', 0):.2e} ({m['wall_s']:.1f}s)"
            )
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            ckpt.save_rotating(ckpt_dir, checkpoint_tree(module, params, opt_state),
                               i + 1)
    if ckpt_dir:
        ckpt.save_rotating(ckpt_dir, checkpoint_tree(module, params, opt_state),
                           num_steps)
    return TrainResult(params=params, opt_state=opt_state, history=history)
