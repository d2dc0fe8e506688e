"""The program each (architecture, input shape) runs, for the dry run (port
of ``repro.launch.specs``).

The reference builds ``ShapeDtypeStruct`` stand-ins and lowers its jitted
entry points.  A port model owns its weights, so :func:`build_program`
builds the model itself, on ``meta`` (shapes and dtypes, no storage),
with the weights the entry point uses: float32 storage for
``train_step`` (the reference's ``param_dtype``), the config's dtype for
``prefill_step`` and ``decode_step`` (serving weights), and inputs of the
same shapes as the reference's.  ``program.fn(*program.args)`` run
``program.repeat`` times, then ``program.tail()`` once, is the entry
point's work; under :class:`repro_torch.launch.op_count.OpCounter` that
counts its FLOPs and bytes (:func:`repro_torch.launch.dryrun.count_program`).
The train step accumulates gradients over ``train_microbatches`` equal
microbatches, so its ``fn`` is one microbatch's loss and backward
(``repeat`` of them) and its ``tail`` the one AdamW update.  On a
partitioned layout (DTensors) each gradient is a share of the sum over
the data axes until the update places it as its parameter, once: the
data-parallel all-reduce, or the reduce-scatter of an fsdp-split one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import InputShape, long_context_policy
from repro_torch.models.model import Model, build_model
from repro_torch.parallel import dtensor as DT
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import trainable


def _extras(cfg: ModelConfig, batch: int) -> dict:
    """The stub modality inputs of the vlm (patches) and audio (frames)
    families."""
    key = {"vlm": "patches", "audio": "frames"}.get(cfg.family)
    if key is None:
        return {}
    shape = (batch, cfg.frontend.num_positions, cfg.d_model)
    return {key: torch.empty(shape, dtype=cfg.dtype, device="meta")}


def decode_slots(cfg: ModelConfig, shape: InputShape) -> int:
    """Cache slots for a decode shape (a ring for windowed archs)."""
    if shape.seq_len > 65536:  # long_500k
        if long_context_policy(cfg) == "swa":
            return cfg.long_context_window + cfg.num_meta_tokens
        if cfg.sliding_window:
            return cfg.sliding_window + cfg.num_meta_tokens
        # SSM-only stacks still create (tiny) attention caches in hybrid
        return (cfg.sliding_window or 4096) + cfg.num_meta_tokens
    return shape.seq_len + cfg.num_meta_tokens


def decode_window_override(cfg: ModelConfig, shape: InputShape) -> int:
    if shape.seq_len > 65536 and long_context_policy(cfg) == "swa":
        return cfg.long_context_window
    return -1


def train_microbatches(cfg: ModelConfig, shape: InputShape, dp: int = 16,
                       act_budget: float = 3e9) -> int:
    """Gradient-accumulation factor so the saved layer inputs (L x B_dev/mu
    x S x d x 2 B) fit the activation budget; mu is a power of two capped
    at one sample per device per microbatch (B/dp)."""
    b_dev = max(shape.global_batch // dp, 1)
    acts = cfg.num_layers * b_dev * shape.seq_len * cfg.d_model * 2
    mu = 1
    while acts / mu > act_budget and mu < b_dev:
        mu *= 2
    return mu


@dataclasses.dataclass
class Program:
    """An entry point and its inputs: ``fn(*args)`` ``repeat`` times, then
    ``tail()``, runs it once.  ``model`` is the model it runs (its
    parameters are the program's weights), ``state`` the program's other
    device state by kind (``opt``: AdamW's moments, ``cache``: the decode
    or prefill cache, ``batch``: the inputs)."""

    name: str
    fn: Callable
    args: tuple
    model: Model
    state: dict
    repeat: int = 1
    tail: Callable | None = None


def _tokens(*shape: int) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def build_program(cfg: ModelConfig, shape: InputShape, dp: int = 16) -> Program:
    """The entry point a given input shape exercises, on ``meta``."""
    from repro_torch.launch.train import train_config

    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        mu = train_microbatches(cfg, shape, dp)
        model = build_model(train_config(cfg), device="meta")
        state = opt.init_state(trainable(model))
        batch = {"tokens": _tokens(b, s), **_extras(cfg, b)}

        def microbatch(micro):
            loss, _ = model.loss(micro)
            loss.backward()

        def update():
            params = dict(model.named_parameters())
            grads = {n: DT.placed_like(p.grad, p) if p.grad is not None
                     else torch.zeros_like(p) for n, p in params.items()}
            opt.apply_updates(opt.OptimizerConfig(), params, grads, state)

        micro = {k: v[: b // mu] for k, v in batch.items()}
        return Program("train_step", microbatch, (micro,), model,
                       {"opt": state, "batch": batch}, repeat=mu, tail=update)

    model = build_model(cfg, device="meta")     # serving weights
    if shape.kind == "prefill":
        batch = {"tokens": _tokens(b, s), **_extras(cfg, b)}
        slots = s + cfg.num_meta_tokens

        def prefill(batch):
            return model.prefill(batch["tokens"], slots,
                                 **{k: v for k, v in batch.items() if k != "tokens"})

        cache = model.init_cache(b, slots)      # the cache the prefill fills
        return Program("prefill_step", prefill, (batch,), model,
                       {"cache": cache, "batch": batch})

    slots = decode_slots(cfg, shape)
    wo = decode_window_override(cfg, shape)
    # the last position the cache holds (whisper's learned positions end
    # at max_position)
    pos = min(slots, cfg.max_position if cfg.family == "audio" else slots) - 1
    batch = {"tokens": _tokens(b, 1)}
    cache = model.init_cache(b, slots)

    def decode(cache, batch):
        return model.decode(cache, batch["tokens"], pos, window_override=wo)

    return Program("decode_step", decode, (cache, batch), model,
                   {"cache": cache, "batch": batch})
