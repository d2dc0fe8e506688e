"""Training launcher of the port (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --diffusion --steps 10 --batch 8 --seq 256
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 20 --batch 8 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --diffusion --steps 20 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepseek-v2-lite-16b --layers 7 --steps 10 --batch 8 --seq 256

It runs on the card unless ``--device cpu`` is given, and raises without a
card.  Weights are random, drawn from ``--seed``, and stored in float32
(the reference's ``param_dtype``; compute stays in the config's dtype, bf16
at full width).  ``--diffusion`` trains the diffusion-LM denoiser (the
paper's setting) on :class:`repro_torch.data.GaussianMixtureLatents`;
otherwise the token model trains on :class:`repro_torch.data.TokenStream`,
the audio and vlm families with stub frames or image patches drawn by
:func:`repro_torch.data.frontend_features` from a numpy generator of
``--seed``, as the reference draws them.  AdamW warms up over
``max(steps // 20, 5)`` steps, then decays by a cosine.  ``--ckpt-dir``
keeps archives keyed as the reference's trees
(:mod:`repro_torch.training.checkpoint`).  ``--layers N`` keeps the first
N layers of a model whose training state (16 bytes a parameter: float32
weights, gradients and AdamW's two moments) does not fit one card at full
depth, as deepseek-v2-lite-16b's 27 layers (~250 GB) do not; the widths
stay.
"""

from __future__ import annotations

import argparse
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.configs import arch_names, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import linear_schedule
from repro_torch.data import DataConfig, frontend_features, make_loader
from repro_torch.models import DiffusionLM, build_model
from repro_torch.training import (
    OptimizerConfig,
    make_diffusion_train_step,
    make_lm_train_step,
    train,
)


def cut_layers(cfg: ModelConfig, layers: int) -> ModelConfig:
    """``cfg`` with its first ``layers`` layers: its block pattern cut
    there, every width unchanged."""
    if not 0 < layers <= cfg.num_layers:
        raise ValueError(f"{cfg.name}: --layers {layers} not in 1..{cfg.num_layers}")
    pattern, left = [], layers
    for kind, n in cfg.blocks:
        if left:
            pattern.append((kind, min(n, left)))
            left -= pattern[-1][1]
    return cfg.with_(num_layers=layers, stack_pattern=tuple(pattern))


def train_config(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with float32 parameter storage, as the reference trains."""
    return cfg.with_(param_dtype=torch.float32)


def lm_batches(cfg: ModelConfig, batch: int, seq: int, seed: int) -> Iterator[dict]:
    """Token batches, with the vlm family's image patches or the audio
    family's frames drawn from a numpy generator of ``seed``."""
    rng = np.random.default_rng(seed)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch,
                    seed=seed)
    for b in make_loader(dc).batches():
        if cfg.family in ("vlm", "audio"):
            key = "patches" if cfg.family == "vlm" else "frames"
            b[key] = frontend_features(rng, batch, cfg.frontend.num_positions,
                                       cfg.d_model)
        yield b


def diffusion_batches(cfg: ModelConfig, batch: int, seq: int,
                      seed: int) -> Iterator[dict]:
    """Gaussian-mixture latent batches of width ``d_model``."""
    dc = DataConfig(vocab_size=1, seq_len=seq, batch_size=batch,
                    kind="diffusion", d_model=cfg.d_model, seed=seed)
    return make_loader(dc).batches()


def setup(
    cfg: ModelConfig, *, diffusion: bool, steps: int, batch: int, seq: int,
    lr: float = 3e-4, seed: int = 0, device=None,
) -> tuple[Callable, Iterator[dict]]:
    """The train step (with ``.module`` and ``.params``) of a fresh model
    of ``cfg`` in float32 storage on ``device`` (the card by default), and
    its numpy batch stream."""
    cfg = train_config(cfg)
    opt_cfg = OptimizerConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                              total_steps=steps)
    if diffusion:
        dlm = DiffusionLM(cfg, device=device, seed=seed)
        step = make_diffusion_train_step(dlm, opt_cfg, linear_schedule())
        return step, diffusion_batches(cfg, batch, seq, seed)
    model = build_model(cfg, device=device, seed=seed)
    return make_lm_train_step(model, opt_cfg), lm_batches(cfg, batch, seq, seed)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b", choices=arch_names())
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--diffusion", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers (the widths stay)")
    ap.add_argument(
        "--device", default=None,
        help="torch device to run on (default: the CUDA card; 'cpu' runs "
             "the plain PyTorch path)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers is not None:
        cfg = cut_layers(cfg, args.layers)
    step, batches = setup(
        cfg, diffusion=args.diffusion, steps=args.steps, batch=args.batch,
        seq=args.seq, lr=args.lr, seed=args.seed, device=args.device)
    n_params = sum(p.numel() for p in step.params.values())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M steps={args.steps}")
    res = train(step, batches, args.steps, seed=args.seed,
                ckpt_dir=args.ckpt_dir)
    print(f"final loss: {res.history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
