"""Weight interop: the reference's parameter trees -> the port's modules.

Each function takes a reference parameter tree with every leaf converted
to a numpy array and returns a state dict for ``load_state_dict``:

* ``params_from_jax(tree, cfg)``: the tree of
  ``repro.models.diffusion.DiffusionLM.init``, for
  ``repro_torch.models.DiffusionLM``.  Its token embedding (and LM head)
  are not used by the denoiser and are dropped.
* ``model_params_from_jax(tree, cfg)``: the tree of
  ``repro.models.build_model(cfg).init(key)`` (``embed``, ``final_norm``,
  ``segs``, ``lm_head`` where the embeddings are untied, ``meta`` where
  the config has meta tokens, and whisper's ``pos_embed`` and
  ``encoder``), for ``repro_torch.models.Model``.  The reference's
  ``embed`` already has ``padded_vocab`` rows, so it is copied as it is.
  The denoiser drops ``meta``, ``pos_embed`` and ``encoder`` with the
  embedding.

The reference stacks each segment's per-layer parameters on a leading
layer axis under ``segs["<i>_<kind>"]``; layer ``j`` of a segment is the
port's ``backbone.layers.<first + j>``, and the keys below it are the
reference's nested keys joined by dots in both packages: ``ln1.scale``,
``attn.{wq,wk,wv,wo}.{w,b}`` and ``mlp.{wi,wg,wo}.w`` (dense),
``moe.router.w``, ``moe.experts.{wi,wg,wo}`` ((E, d, f) / (E, f, d)) and
``moe.shared.{wi,wg,wo}.w`` (moe, mla_moe), ``mla.{wq,wkv_a,wkv_b,wo}.w``
and ``mla.ckv_norm.scale`` (mla_moe); ``mamba.{in_proj,x_proj,dt_proj,
out_proj}.{w,b}``, ``mamba.conv.{w,b}``, ``mamba.A_log``, ``mamba.D``,
``attn_norm.scale`` and ``mamba_norm.scale`` beside the dense block's keys
(hymba_swa, hymba_full); ``norm``, ``up``, ``conv``, ``wq``, ``wk``,
``wv``, ``wi``, ``wf``, ``out_norm`` and ``down`` (mlstm); ``norm``,
``w{z,i,f,o}``, ``r{z,i,f,o}`` ((nh, hd, hd)), ``out_norm`` and ``down``
(slstm); ``ln1``, ``attn``, ``ln2`` and ``mlp.{wi,wo}.w`` (enc: the
encoder's ``encoder.segs.0_enc`` is the port's ``encoder.layers.<j>``,
its ``encoder.norm`` the port's), ``ln1``, ``self_attn``, ``ln_x``,
``cross_attn``, ``ln2`` and ``mlp.{wi,wo}.w`` (xdec), each layernorm with
``scale`` and ``bias`` (as the audio family's ``final_norm``).  A linear
weight is ``(d_in, d_out)`` in both packages, so nothing is transposed.  qwen2 has biases on wq/wk/wv, llama has none.
Loading casts each tensor to the dtype of the module parameter it fills
(the MoE router, ``A_log``, ``D`` and ``r{z,i,f,o}`` stay float32).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _linear(prefix: str, p: dict) -> dict:
    return {f"{prefix}.{name}": _t(p[name]) for name in ("w", "b") if name in p}


def _leaves(tree: dict, prefix: str = ""):
    """(dotted key, array) of every leaf of a nested dict."""
    for name, sub in tree.items():
        key = f"{prefix}.{name}" if prefix else name
        if isinstance(sub, dict):
            yield from _leaves(sub, key)
        else:
            yield key, sub


def _layers(prefix: str, seg: dict, count: int, layer0: int = 0) -> dict:
    """``<prefix>.layers.<layer0 + j>.<key>`` entries of layer ``j`` of a
    segment whose leaves are stacked on a leading layer axis."""
    leaves = list(_leaves(seg))
    return {
        f"{prefix}.layers.{layer0 + j}.{key}": _t(stacked[j])
        for j in range(count) for key, stacked in leaves
    }


def _backbone(segs: dict, final_norm: dict, cfg: ModelConfig) -> dict:
    """``backbone.*`` entries: the per-layer parameters of every segment,
    then the final norm (with its bias, for the audio family)."""
    sd: dict[str, torch.Tensor] = {}
    layer0 = 0
    for seg_i, (kind, count) in enumerate(cfg.blocks):
        sd.update(_layers("backbone", segs[f"{seg_i}_{kind}"], count, layer0))
        layer0 += count
    for key, leaf in _leaves(final_norm):
        sd[f"backbone.final_norm.{key}"] = _t(leaf)
    return sd


def params_from_jax(tree: dict[str, Any], cfg: ModelConfig) -> dict:
    bb = tree["backbone"]
    sd = _backbone(bb["segs"], bb["final_norm"], cfg)
    for name in ("w1", "w2"):
        sd.update(_linear(f"time_mlp.{name}", tree["time_mlp"][name]))
    sd.update(_linear("in_proj", tree["in_proj"]))
    sd.update(_linear("eps_head", tree["eps_head"]))
    return sd


def model_params_from_jax(tree: dict[str, Any], cfg: ModelConfig) -> dict:
    sd = _backbone(tree["segs"], tree["final_norm"], cfg)
    sd["embed"] = _t(tree["embed"])
    if not cfg.tie_embeddings:
        sd["lm_head.w"] = _t(tree["lm_head"])
    if cfg.num_meta_tokens:
        sd["meta"] = _t(tree["meta"])
    if cfg.family == "audio":
        sd["pos_embed"] = _t(tree["pos_embed"])
        enc = tree["encoder"]
        sd.update(_layers("encoder", enc["segs"]["0_enc"],
                          cfg.num_encoder_layers))
        for key, leaf in _leaves(enc["norm"]):
            sd[f"encoder.norm.{key}"] = _t(leaf)
    return sd
