"""Serving launcher of the port: AR generation or diffusion sampling with
any registry solver (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --mode ar --batch 8 --prompt-len 512 --gen 64 --max-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --mode ar --batch 4 --prompt-len 16 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --mode diffusion --solver era --nfe 10

Runs on the card unless ``--device cpu`` is given.  Weights are random,
drawn from ``--seed``; the prompts are drawn from the same seed with numpy,
as the reference draws them.  The diffusion mode builds its engine with
:func:`repro_torch.serving.build_engine`, as every reference serve mode
does, and serves one request through it.  The continuous-batching
simulator, the HTTP front door and its client (``--continuous``,
``--listen``, ``--connect``) and the vlm and audio families are not ported
yet: asking for them exits with an error that names the ROADMAP item
they wait in, by its title.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import arch_names, get_config
from repro_torch.core import linear_schedule, solver_names
from repro_torch.models import DiffusionLM, build_model
from repro_torch.serving import (
    Engine,
    EngineConfig,
    SampleRequest,
    SamplerService,
    ServeConfig,
    build_engine,
    result_keys as K,
)


def run_ar(args) -> None:
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=args.device, seed=args.seed)
    eng = Engine(model, ServeConfig(max_len=args.max_len,
                                    window_override=args.window))
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    ).to(torch.int32)
    t0 = time.perf_counter()
    toks = eng.generate(prompts, args.gen).cpu()  # the copy waits for the card
    dt = time.perf_counter() - t0
    print(
        f"generated {tuple(toks.shape)} in {dt:.2f}s "
        f"({args.batch * args.gen / dt:.1f} tok/s); first row: "
        f"{toks[0][:10].tolist()}"
    )


def run_diffusion(args) -> None:
    cfg = get_config(args.arch, smoke=args.smoke)
    dlm = DiffusionLM(cfg, device=args.device, seed=args.seed)
    # the one-shot facade: exact-size batches, the paper's shared delta_eps
    engine = build_engine(dlm, linear_schedule(), EngineConfig(
        solver=args.solver, nfe=args.nfe, k=args.k, lam=args.lam,
        per_sample=False, batch_buckets=None,
    ))
    res = SamplerService(engine=engine).sample(SampleRequest(
        batch=args.batch, seq_len=args.seq, nfe=args.nfe, seed=args.seed
    ))
    x0 = res.x0.float()
    print(
        f"sampled latents {tuple(x0.shape)} via {args.solver} nfe={args.nfe} "
        f"in {res.info[K.WALL_S]:.2f}s "
        f"(mean {float(x0.mean()):+.4f}, std {float(x0.std()):.4f})"
    )


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mode", choices=["ar", "diffusion"], default="ar")
    ap.add_argument(
        "--device", default=None,
        help="torch device to run on (default: the CUDA card; 'cpu' runs "
        "the plain PyTorch path)",
    )
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--window", type=int, default=-1)
    ap.add_argument("--solver", default="era", choices=solver_names())
    ap.add_argument("--nfe", type=int, default=10)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--lam", type=float, default=5.0)
    ap.add_argument("--seq", type=int, default=32, help="diffusion seq len")
    ap.add_argument("--seed", type=int, default=0)
    for flag in ("--continuous", "--listen"):
        ap.add_argument(flag, action="store_true", help="not ported yet")
    ap.add_argument("--connect", default=None, metavar="URL",
                    help="not ported yet")
    args = ap.parse_args(argv)
    if args.continuous or args.listen or args.connect:
        ap.error(
            "--continuous/--listen/--connect (the scheduler and the HTTP "
            "front door) are not ported yet: ROADMAP, queue 'modules to "
            "port', item 'Serving surface'"
        )
    if args.arch not in arch_names():
        ap.error(
            f"architecture {args.arch!r} is not ported yet (ported: "
            f"{arch_names()}); the other families (moe, ssm, hybrid, vlm, "
            f"audio) wait in ROADMAP, queue 'modules to port', item 'Other "
            f"denoiser families'"
        )
    if args.mode == "ar":
        run_ar(args)
    else:
        run_diffusion(args)


if __name__ == "__main__":
    main()
