"""Quickstart on the PyTorch port: train a diffusion-LM denoiser, sample
with ERA-Solver, report quality against the known data distribution, then
serve the same model through the batched engine (the port's counterpart
of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py               # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --steps 20

The denoiser is the smoke qwen2-1.5b (2 layers, d_model 128); on the card
it computes in bf16, as the kernels do.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ERAConfig, get_solver, linear_schedule  # noqa: E402
from repro_torch.data import DataConfig, GaussianMixtureLatents  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.train import train_config  # noqa: E402
from repro_torch.models import DiffusionLM  # noqa: E402
from repro_torch.serving import BatchedSampler, SampleRequest  # noqa: E402
from repro_torch.training import (  # noqa: E402
    OptimizerConfig,
    make_diffusion_train_step,
    train,
)


def example_config(name: str, device: torch.device):
    """The smoke config of ``name``, in bf16 on the card (the kernels'
    dtype), float32 on the CPU."""
    cfg = get_config(name, smoke=True)
    return cfg.with_(dtype=torch.bfloat16) if device.type == "cuda" else cfg


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--nfe", type=int, default=10)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = train_config(example_config("qwen2-1.5b", dev))
    dlm = DiffusionLM(cfg, device=dev, seed=args.seed)
    n = sum(p.numel() for p in dlm.parameters())
    print(f"denoiser: {cfg.name} ({n / 1e6:.2f}M params) on {dev}, seq={args.seq}")

    sched = linear_schedule()
    data = GaussianMixtureLatents(DataConfig(
        vocab_size=1, seq_len=args.seq, batch_size=args.batch, kind="diffusion",
        d_model=cfg.d_model, num_modes=4, seed=args.seed))
    step = make_diffusion_train_step(dlm, OptimizerConfig(
        lr=2e-3, warmup_steps=max(args.steps // 20, 5), total_steps=args.steps), sched)
    res = train(step, data.batches(), args.steps, seed=args.seed,
                log_every=max(args.steps // 4, 1), ckpt_dir=args.ckpt_dir)
    first, last = res.history[0]["loss"], res.history[-1]["loss"]
    print(f"trained: loss {first:.4f} -> {last:.4f}")

    # --- sample with ERA-Solver (the paper's Algorithm 1) ---
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    x_t = torch.randn((args.samples, args.seq, cfg.d_model), generator=gen, device=dev)
    out = get_solver("era")(
        dlm.eps_fn(), x_t, sched,
        ERAConfig(nfe=args.nfe, k=3, lam=5.0, error_norm="mean"), device=dev)
    mu, var = data.moments()
    got = out.x0.reshape(-1, cfg.d_model).float().cpu().numpy()
    mu_err = float(np.linalg.norm(got.mean(0) - mu) / np.linalg.norm(mu))
    var_err = float(np.linalg.norm(got.var(0) - var) / np.linalg.norm(var))
    print(f"ERA-Solver @ NFE={args.nfe}: mean-err {mu_err:.3f}, var-err "
          f"{var_err:.3f} (vs the data's moments)")
    hist = [round(float(d), 3) for d in out.aux["delta_eps_history"][3:]]
    print(f"delta_eps history: {hist}")

    # --- the same model behind the batched serving engine ---
    engine = BatchedSampler(dlm, sched, batch_buckets=(1, 8))
    futs = [engine.submit_with_future(
        SampleRequest(batch=1, seq_len=args.seq, nfe=args.nfe, seed=s))[1]
        for s in range(4)]
    engine.drain()
    results = [f.result() for f in futs]
    lat = sum(r.latency_s for r in results) / len(results)
    print(f"batched engine: {len(results)} requests fused to batch "
          f"{results[0].padded_batch}, mean latency {lat * 1e3:.1f} ms "
          f"({len(engine.compile_cache())} captured bucket graphs)")
    return {"loss": (first, last), "mean_err": mu_err, "var_err": var_err,
            "x0": out.x0, "served": results}


if __name__ == "__main__":
    main()
