"""Weight interop between the reference's parameter trees and the port's
modules, both ways.

Each ``*_from_jax`` function takes a reference parameter tree with every
leaf converted to a numpy array and returns a state dict for
``load_state_dict``; each ``*_to_jax`` function is its inverse, from a
state dict (tensors) to a nested dict of numpy float32 arrays keyed as the
reference's tree, each segment's layers stacked again on a leading axis.
The training checkpoints (:mod:`repro_torch.training.checkpoint`) are
written through them, so they load in the reference's ``restore``:

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

A denoiser's round trip: the reference's DiffusionLM tree carries the
token model's leaves under ``backbone`` (``embed``, and ``lm_head``,
``meta``, ``pos_embed`` or ``encoder`` where the config has them), which
its ``eps`` never reads.  ``params_from_jax`` drops them and
``params_to_jax`` writes a tree without them: the reference's ``restore``
loads it and its ``eps`` runs on it, but a reference tree that went
through the port has lost those leaves.

The AdamW state maps the same way (:func:`opt_state_to_jax`,
:func:`opt_state_from_jax`): ``m`` and ``v`` keyed as the parameters, and
``step``.
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


# ---------------------------------------------------------------------------
# the port -> the reference's trees
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _put(tree: dict, dotted: str, value) -> None:
    parts = dotted.split(".")
    cur = tree
    for part in parts[:-1]:
        cur = cur.setdefault(part, {})
    cur[parts[-1]] = value


def _stack_layers(sd: dict, prefix: str, count: int, layer0: int = 0) -> dict:
    """The nested segment tree of ``<prefix>.layers.<layer0 + j>.*`` for j
    < count, each leaf the stack of its layers' tensors on axis 0."""
    first = f"{prefix}.layers.{layer0}."
    keys = [k[len(first):] for k in sd if k.startswith(first)]
    seg: dict = {}
    for key in keys:
        _put(seg, key, np.stack(
            [_np(sd[f"{prefix}.layers.{layer0 + j}.{key}"]) for j in range(count)]))
    return seg


def _backbone_to_jax(sd: dict, cfg: ModelConfig) -> tuple[dict, dict]:
    """(segs, final_norm) of the reference from the port's ``backbone.*``."""
    segs, layer0 = {}, 0
    for seg_i, (kind, count) in enumerate(cfg.blocks):
        segs[f"{seg_i}_{kind}"] = _stack_layers(sd, "backbone", count, layer0)
        layer0 += count
    final_norm: dict = {}
    for key, t in sd.items():
        if key.startswith("backbone.final_norm."):
            _put(final_norm, key[len("backbone.final_norm."):], _np(t))
    return segs, final_norm


def params_to_jax(state_dict: dict, cfg: ModelConfig) -> dict:
    """The inverse of :func:`params_from_jax`: a denoiser's state dict (or
    any dict of its named tensors) as the reference's DiffusionLM tree,
    without the token model's leaves (see the module docstring)."""
    segs, final_norm = _backbone_to_jax(state_dict, cfg)
    tree: dict = {"backbone": {"segs": segs, "final_norm": final_norm}}
    for key, t in state_dict.items():
        if key.split(".")[0] in ("time_mlp", "in_proj", "eps_head"):
            _put(tree, key, _np(t))
    return tree


def model_params_to_jax(state_dict: dict, cfg: ModelConfig) -> dict:
    """The inverse of :func:`model_params_from_jax`: a token model's state
    dict as the reference's ``Model`` tree."""
    segs, final_norm = _backbone_to_jax(state_dict, cfg)
    tree: dict = {"segs": segs, "final_norm": final_norm,
                  "embed": _np(state_dict["embed"])}
    if not cfg.tie_embeddings:
        tree["lm_head"] = _np(state_dict["lm_head.w"])
    if cfg.num_meta_tokens:
        tree["meta"] = _np(state_dict["meta"])
    if cfg.family == "audio":
        tree["pos_embed"] = _np(state_dict["pos_embed"])
        norm: dict = {}
        for key, t in state_dict.items():
            if key.startswith("encoder.norm."):
                _put(norm, key[len("encoder.norm."):], _np(t))
        tree["encoder"] = {
            "segs": {"0_enc": _stack_layers(state_dict, "encoder",
                                            cfg.num_encoder_layers)},
            "norm": norm,
        }
    return tree


def opt_state_to_jax(state: dict, cfg: ModelConfig, denoiser: bool) -> dict:
    """The port's AdamW state ({"m", "v": {name: tensor}, "step"}) as the
    reference's ({"m", "v": trees keyed as the parameters, "step": int32})."""
    to = params_to_jax if denoiser else model_params_to_jax
    return {"m": to(state["m"], cfg), "v": to(state["v"], cfg),
            "step": np.asarray(int(state["step"]), dtype=np.int32)}


def opt_state_from_jax(tree: dict, cfg: ModelConfig, denoiser: bool) -> dict:
    """The inverse of :func:`opt_state_to_jax`, on the CPU: the moments as
    float32 tensors keyed by parameter name, ``step`` a 0-d int32 tensor."""
    frm = params_from_jax if denoiser else model_params_from_jax
    return {"m": frm(tree["m"], cfg), "v": frm(tree["v"], cfg),
            "step": torch.tensor(int(tree["step"]), dtype=torch.int32)}
