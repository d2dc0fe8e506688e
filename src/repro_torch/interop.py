"""Weight interop: the reference's parameter tree -> the port's modules.

``params_from_jax(tree, cfg)`` takes the dict that
``repro.models.diffusion.DiffusionLM.init`` returns, with every leaf
converted to a numpy array, and returns a state dict for
``repro_torch.models.DiffusionLM.load_state_dict``.  The reference stacks
each segment's per-layer parameters on a leading layer axis under
``params["backbone"]["segs"]["<i>_<kind>"]``; a linear weight is
``(d_in, d_out)`` in both packages, so nothing is transposed.  qwen2 has
biases on wq/wk/wv, llama has none.  The token embedding (and LM head) of
the reference tree are not used by the denoiser and are dropped.
Loading casts each tensor to the dtype of the module parameter it fills.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _linear(prefix: str, p: dict, layer: int | None = None) -> dict:
    pick = (lambda a: a) if layer is None else (lambda a: a[layer])
    out = {f"{prefix}.w": _t(pick(p["w"]))}
    if "b" in p:
        out[f"{prefix}.b"] = _t(pick(p["b"]))
    return out


def params_from_jax(tree: dict[str, Any], cfg: ModelConfig) -> dict:
    sd: dict[str, torch.Tensor] = {}
    bb = tree["backbone"]
    layer0 = 0
    for seg_i, (kind, count) in enumerate(cfg.blocks):
        if kind != "dense":
            raise NotImplementedError(f"block kind {kind!r} is not ported yet")
        seg = bb["segs"][f"{seg_i}_{kind}"]
        for j in range(count):
            pre = f"backbone.layers.{layer0 + j}"
            sd[f"{pre}.ln1.scale"] = _t(seg["ln1"]["scale"][j])
            sd[f"{pre}.ln2.scale"] = _t(seg["ln2"]["scale"][j])
            for name in ("wq", "wk", "wv", "wo"):
                sd.update(_linear(f"{pre}.attn.{name}", seg["attn"][name], j))
            for name in seg["mlp"]:
                sd.update(_linear(f"{pre}.mlp.{name}", seg["mlp"][name], j))
        layer0 += count
    sd["backbone.final_norm.scale"] = _t(bb["final_norm"]["scale"])
    for name in ("w1", "w2"):
        sd.update(_linear(f"time_mlp.{name}", tree["time_mlp"][name]))
    sd.update(_linear("in_proj", tree["in_proj"]))
    sd.update(_linear("eps_head", tree["eps_head"]))
    return sd
