"""Compare every registered solver on one trained denoiser with the
PyTorch port: the paper's Tables 1-3 in miniature, printed as a table (the
port's counterpart of ``examples/compare_solvers.py``).

    PYTHONPATH=src python examples/torch_compare_solvers.py --nfes 5 10 20
    PYTHONPATH=src python examples/torch_compare_solvers.py --device cpu \\
        --train-steps 10 --nfes 6 --ref-nfe 50
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ERAConfig,
    default_config,
    get_solver,
    linear_schedule,
    solver_names,
)
from repro_torch.data import DataConfig, GaussianMixtureLatents  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.train import train_config  # noqa: E402
from repro_torch.models import DiffusionLM  # noqa: E402
from repro_torch.training import (  # noqa: E402
    OptimizerConfig,
    make_diffusion_train_step,
    train,
)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--nfes", type=int, nargs="+", default=[5, 10, 20])
    ap.add_argument("--train-steps", type=int, default=100)
    ap.add_argument("--ref-nfe", type=int, default=600,
                    help="steps of the DDIM reference every solver is scored against")
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("llama3.2-1b", smoke=True)
    if dev.type == "cuda":          # the kernels compute in bf16
        cfg = cfg.with_(dtype=torch.bfloat16)
    dlm = DiffusionLM(train_config(cfg), device=dev, seed=args.seed)
    sched = linear_schedule()
    data = GaussianMixtureLatents(DataConfig(
        vocab_size=1, seq_len=8, batch_size=16, kind="diffusion",
        d_model=cfg.d_model, num_modes=2, seed=3))
    step = make_diffusion_train_step(
        dlm, OptimizerConfig(lr=2e-3, total_steps=args.train_steps), sched)
    train(step, data.batches(), args.train_steps, seed=args.seed,
          log_every=10**9, print_fn=lambda s: None)
    eps_fn = dlm.eps_fn()

    gen = torch.Generator(device=dev).manual_seed(7)
    x_t = torch.randn((args.samples, 8, cfg.d_model), generator=gen, device=dev)
    ref = get_solver("ddim")(eps_fn, x_t, sched,
                             default_config("ddim", nfe=args.ref_nfe), device=dev).x0

    table: dict[str, dict[int, float | None]] = {}
    print(f"{'solver':22s} " + " ".join(f"NFE={n:<3d}" for n in args.nfes))
    for name in solver_names():
        row = {}
        for nfe in args.nfes:
            conf = (ERAConfig(nfe=nfe, k=3, error_norm="mean") if name == "era"
                    else default_config(name, nfe=nfe))
            try:
                x0 = get_solver(name)(eps_fn, x_t, sched, conf, device=dev).x0
            except ValueError:          # a budget below the solver's order
                row[nfe] = None
                continue
            row[nfe] = float(torch.sqrt(torch.mean((x0.float() - ref.float()) ** 2)))
        table[name] = row
        cells = ["  n/a " if v is None else f"{v:.4f}" for v in row.values()]
        print(f"{name:22s} " + " ".join(f"{c:>7s}" for c in cells))
    print(f"\n(RMSE to a {args.ref_nfe}-step DDIM reference on the same trained "
          f"model; lower is better)")
    return table


if __name__ == "__main__":
    main()
