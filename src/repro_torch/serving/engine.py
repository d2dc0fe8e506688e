"""Autoregressive serving engine: batched prefill + decode over a KV cache
(port of ``repro.serving.engine``).

Long-context policy: decode caches size ``min(max_len, window)`` slots;
a dense architecture asked for more than 65,536 positions runs the
sliding-window variant (ring-buffer cache, ``window_override``).

The reference jits its steps and donates the cache to each decode step;
the port runs eagerly and updates the cache in place.  The decode
position is a host ``int`` and the sampled tokens stay on the device until
the end of :meth:`Engine.generate`, so the decode loop makes no host sync.

With ``mesh=`` (a data-axis :class:`~repro_torch.launch.mesh.Mesh`) a
request's batch splits into dp contiguous row blocks when dp divides it,
each prefilled and decoded on its mesh device against that device's copy
of the weights (its cache stays there for the whole generation); otherwise
it runs whole on the model's own device, which must be the mesh's first:
that is what the reference's replicated placement computes.  Each step's
logits are gathered in row order on that device and sampled there, as one
batch, so greedy and sampled tokens are those of the unsplit batch.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import long_context_policy
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import ParamReplicator, device_scope, serving_dp

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 4096              # max absolute positions served
    window_override: int = -1        # -1: arch default; >0 force SWA window
    greedy: bool = True
    temperature: float = 1.0


def cache_slots(cfg: ModelConfig, serve: ServeConfig) -> int:
    """How many KV slots the decode cache needs."""
    window = serve.window_override
    if window < 0:
        window = cfg.sliding_window
    if window and window > 0:
        return min(serve.max_len, window + cfg.num_meta_tokens)
    return serve.max_len


def resolve_window(cfg: ModelConfig, serve: ServeConfig, seq_len: int) -> int:
    """Window to run decode with (0 = full attention, -1 = each block's
    own)."""
    if serve.window_override >= 0:
        return serve.window_override
    if long_context_policy(cfg) == "swa" and seq_len > 65536:
        return cfg.long_context_window
    return -1


class Engine:
    """Synchronous batched serving around a :class:`Model` (data-parallel
    over ``mesh``'s devices when one is given; see the module docstring)."""

    def __init__(self, model: Model, serve: ServeConfig = ServeConfig(),
                 mesh=None):
        self.model = model
        self.serve = serve
        self.cfg = model.config
        self.slots = cache_slots(self.cfg, serve)
        self.mesh = mesh
        self.dp = 1 if mesh is None else serving_dp(mesh, model.device)
        self._replicate = None if mesh is None else ParamReplicator(mesh)

    def _blocks(self, batch: int) -> list[tuple[Model, slice]]:
        """(model, rows) of each block a batch of ``batch`` rows runs as."""
        if self.dp == 1 or batch % self.dp:
            return [(self.model, slice(0, batch))]
        replicas = self._replicate(self.model)
        n = batch // self.dp
        return [(replicas[i], slice(i * n, (i + 1) * n)) for i in range(self.dp)]

    # ---- steps ----
    def prefill_step(
        self, tokens: Tensor, window_override: int = -1,
        extras: dict | None = None,
    ) -> tuple[Tensor, dict]:
        """``extras``: the stub modality inputs, ``frames`` (audio) or
        ``patches`` (vlm), (B, positions, d_model)."""
        return self.model.prefill(tokens, self.slots, window_override,
                                  **(extras or {}))

    def decode_step(
        self, cache: dict, tokens: Tensor, pos: int, window_override: int = -1
    ) -> tuple[Tensor, dict]:
        return self.model.decode(cache, tokens, pos, window_override)

    # ---- sampling ----
    def sample_token(
        self, logits: Tensor, generator: torch.Generator | None = None
    ) -> Tensor:
        """(B,) int32 next tokens from the first ``vocab_size`` columns of
        the last position's float32 logits: argmax, or (not greedy) a draw
        from softmax(logits / temperature) by the Gumbel-max trick with
        uniforms from ``generator``."""
        logits = logits[:, -1, : self.cfg.vocab_size].to(torch.float32)
        if self.serve.greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        u = torch.rand(
            logits.shape, generator=generator, device=logits.device,
            dtype=torch.float32,
        )
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(
            logits / self.serve.temperature + gumbel, dim=-1
        ).to(torch.int32)

    def generate(
        self,
        prompts: Tensor,          # (B, S_prompt) int
        max_new_tokens: int,
        generator: torch.Generator | None = None,
        extras: dict | None = None,
    ) -> Tensor:
        """Prefill the prompts (after the stub inputs in ``extras``:
        ``frames`` for the audio family, ``patches`` for the vlm family),
        then decode greedily or sampled; returns (B, max_new_tokens) int32
        tokens.  Sampling draws from ``generator`` (a fresh one seeded 0 on
        the model's device when None)."""
        home = self.model.device
        if generator is None and not self.serve.greedy:
            generator = torch.Generator(device=home).manual_seed(0)
        prompts = prompts.to(home)
        extras = {k: v.to(home) for k, v in (extras or {}).items()}
        wo = resolve_window(
            self.cfg, self.serve, prompts.shape[1] + max_new_tokens
        )
        blocks = self._blocks(prompts.shape[0])
        caches, parts = [], []
        for model, rows in blocks:
            dev = model.device
            with device_scope(dev):
                logits, cache = model.prefill(
                    prompts[rows].to(dev), self.slots, wo,
                    **{k: v[rows].to(dev) for k, v in extras.items()})
            caches.append(cache)
            parts.append(logits)
        # the first decode position follows the meta tokens, the image
        # patches and the prompt
        pos = self.cfg.num_meta_tokens + prompts.shape[1]
        if self.cfg.family == "vlm" and extras:
            pos += extras["patches"].shape[1]
        toks = [self.sample_token(_gather(parts, home), generator)]
        for i in range(max_new_tokens - 1):
            parts = []
            for (model, rows), cache in zip(blocks, caches):
                with device_scope(model.device):
                    logits, _ = model.decode(
                        cache, toks[-1][rows, None].to(model.device), pos + i, wo)
                parts.append(logits)
            toks.append(self.sample_token(_gather(parts, home), generator))
        return torch.stack(toks, dim=1)


def _gather(parts: list[Tensor], device) -> Tensor:
    """Row blocks joined in order on ``device`` (one block: as it is)."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(device) for p in parts])
