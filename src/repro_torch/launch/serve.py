"""Serving launcher of the port: AR generation or diffusion sampling with
any registry solver (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --mode ar --batch 8 --prompt-len 512 --gen 64 --max-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --mode ar --batch 4 --prompt-len 16 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --mode diffusion --solver era --nfe 10
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --arch deepseek-v2-lite-16b --mode diffusion
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --arch hymba-1.5b --mode ar
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --arch xlstm-350m --mode diffusion
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --arch whisper-base --mode ar
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --arch paligemma-3b --mode diffusion
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --mode diffusion --continuous --requests 16 --rate 20
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --mode diffusion --listen --port 0
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --mode diffusion --connect http://127.0.0.1:8752 --requests 4

Every mode runs on the card unless ``--device cpu`` is given; ``--connect``
needs neither a device nor a model.  Weights are random, drawn from
``--seed``; the prompts, and the audio and vlm families' stub frames and
image patches (:func:`repro_torch.data.frontend_features`), are drawn from
the same seed with numpy, as the reference draws them.

``--continuous`` drives the continuous-batching scheduler with a simulated
open-loop client: ``--requests`` one-row requests arrive with Poisson gaps
at ``--rate`` a second, and the run reports p50/p99 arrival-to-result
latency, throughput, and how full the fused batches ran.  ``--listen``
serves the HTTP front door over the same engine and scheduler; once the
socket is bound it prints ``FRONTDOOR READY <url>`` (``--port 0`` binds an
ephemeral port) and serves until interrupted, while the bucket-graph grid
is captured on a background thread behind ``/readyz`` (``--no-warm`` skips
it).  ``--connect URL`` is the matching wire client.

Every diffusion mode builds its engine through
:func:`repro_torch.serving.build_engine` from one :class:`EngineConfig`, as
the reference's ``_engine_config`` does.  The reference's
``--compile-cache-dir`` has no counterpart: CUDA graphs do not persist
across processes.  ``--arch`` takes every architecture of the registry
in every mode: dense (qwen2-1.5b, llama3.2-1b, minitron-4b, deepseek-67b),
MoE (mixtral-8x7b, deepseek-v2-lite-16b), SSM (xlstm-350m), hybrid
(hymba-1.5b), audio (whisper-base) and vlm (paligemma-3b).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import arch_names, get_config
from repro_torch.core import linear_schedule, solver_names
from repro_torch.data import frontend_features
from repro_torch.models import DiffusionLM, build_model
from repro_torch.serving import (
    AsyncBatchedSampler,
    Engine,
    EngineConfig,
    FrontDoorClient,
    SampleRequest,
    SamplerService,
    SchedulerPolicy,
    ServeConfig,
    build_engine,
    open_loop,
    result_keys as K,
    serve_frontdoor,
    warmup_kwargs,
)


def _ints(text: str | None) -> tuple[int, ...] | None:
    return tuple(int(x) for x in text.split(",")) if text else None


def _engine_config(
    args, per_sample: bool, fused: bool,
    warmup_seq_lens: tuple[int, ...] | None = None,
) -> EngineConfig:
    """CLI args -> the one EngineConfig every diffusion mode builds from.
    Fused engines get the serving ladders; the one-shot facade runs exact
    size.  ``warmup_seq_lens`` are the exact lengths the warmup grid covers
    when the engine has no seq ladder."""
    return EngineConfig(
        solver=args.solver,
        nfe=args.nfe,
        k=args.k,
        lam=args.lam,
        per_sample=per_sample,
        batch_buckets=_ints(args.batch_buckets) if fused else None,
        seq_buckets=_ints(args.seq_buckets) if fused else None,
        nfe_buckets=_ints(args.nfe_buckets) if fused else None,
        warmup="grid" if (fused and args.warm) else "none",
        warmup_nfes=_ints(args.warmup_nfes),
        warmup_seq_lens=warmup_seq_lens if fused else None,
    )


def _warm_engine(engine, cfg: EngineConfig, mix) -> None:
    """Capture the engine's bucket-graph grid for every solver in ``mix``
    (on the CPU: validate it)."""
    kw = warmup_kwargs(cfg)
    if kw is None:
        return
    rep = engine.warmup(solvers=tuple(mix), **kw)
    print(
        f"warmup: {rep['programs']} programs in {rep[K.WALL_S]:.2f}s "
        f"({rep['fresh']} captured, {rep['memory']} already captured)",
        flush=True,
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
    extras = {}
    if cfg.frontend is not None:
        key = "frames" if cfg.family == "audio" else "patches"
        extras[key] = torch.from_numpy(frontend_features(
            rng, args.batch, cfg.frontend.num_positions, cfg.d_model))
    t0 = time.perf_counter()
    toks = eng.generate(prompts, args.gen, extras=extras).cpu()  # waits for the card
    dt = time.perf_counter() - t0
    print(
        f"generated {tuple(toks.shape)} in {dt:.2f}s "
        f"({args.batch * args.gen / dt:.1f} tok/s); first row: "
        f"{toks[0][:10].tolist()}"
    )


def run_diffusion(dlm, args) -> None:
    """The one-shot facade: exact-size batches, the paper's shared
    delta_eps."""
    engine = build_engine(
        dlm, linear_schedule(),
        _engine_config(args, per_sample=False, fused=False),
    )
    res = SamplerService(engine=engine).sample(SampleRequest(
        batch=args.batch, seq_len=args.seq, nfe=args.nfe, seed=args.seed
    ))
    x0 = res.x0.float()
    print(
        f"sampled latents {tuple(x0.shape)} via {args.solver} nfe={args.nfe} "
        f"in {res.info[K.WALL_S]:.2f}s "
        f"(mean {float(x0.mean()):+.4f}, std {float(x0.std()):.4f})"
    )


def _stream_mix(args) -> tuple[list[str], list[int], list[int]]:
    """The solvers, seq_lens and NFE budgets a --continuous stream cycles
    through."""
    mix = [s.strip() for s in args.mix.split(",")] if args.mix else [args.solver]
    lens = list(_ints(args.seq_mix_lens) or (args.seq,))
    nfes = list(_ints(args.nfe_mix_nfes) or (args.nfe,))
    return mix, lens, nfes


def continuous_stream(engine, args) -> dict:
    """Serve ``--requests`` one-row requests, Poisson arrivals at
    ``--rate`` drawn from ``--seed``, through a scheduler over ``engine``;
    return the latency percentiles (ms), throughput and batch stats."""
    mix, lens, nfes = _stream_mix(args)
    policy = SchedulerPolicy(
        max_wait_ms=args.max_wait_ms, target_occupancy=args.occupancy
    )
    gaps = np.random.default_rng(args.seed).exponential(
        1.0 / args.rate, args.requests
    )
    futures = []
    with AsyncBatchedSampler(engine, policy) as sched:
        t_start = open_loop(
            gaps,
            lambda i: futures.append(sched.submit(SampleRequest(
                batch=1, seq_len=lens[i % len(lens)], nfe=nfes[i % len(nfes)],
                solver=mix[i % len(mix)], seed=args.seed + i,
            ))),
        )
        results = [f.result() for f in futures]
        makespan = time.perf_counter() - t_start
        stats = sched.stats()
    lats_ms = np.array([r.latency_s for r in results]) * 1e3
    return {
        "p50_ms": float(np.percentile(lats_ms, 50)),
        "p99_ms": float(np.percentile(lats_ms, 99)),
        "throughput_rps": args.requests / makespan,
        "makespan_s": makespan,
        **stats,
    }


def run_continuous(dlm, args) -> dict:
    """Open-loop Poisson client against the continuous-batching scheduler.
    ``--mix`` cycles the stream through several solvers (one fuse queue
    each); ``--seq-mix-lens`` / ``--nfe-mix-nfes`` cycle lengths and
    budgets, which fuse under ``--seq-buckets`` / ``--nfe-buckets``.
    Prints one summary line and returns its figures."""
    mix, lens, _ = _stream_mix(args)
    cfg = _engine_config(
        args, per_sample=True, fused=True, warmup_seq_lens=tuple(lens)
    )
    engine = build_engine(dlm, linear_schedule(), cfg)
    _warm_engine(engine, cfg, mix)
    out = continuous_stream(engine, args)
    print(
        f"continuous[{','.join(mix)}]: {args.requests} req @ {args.rate:.1f}/s "
        f"(max_wait={args.max_wait_ms}ms occ={args.occupancy}) | "
        f"p50={out['p50_ms']:.1f}ms p99={out['p99_ms']:.1f}ms "
        f"thpt={out['throughput_rps']:.1f}/s "
        f"batches={out[K.BATCHES]} "
        f"mean_rows={out[K.MEAN_BATCH_ROWS]:.1f}"
    )
    return out


def run_listen(dlm, args) -> None:
    """HTTP front door: bind, print the ready line, serve until
    interrupted.  The grid (default solver x batch buckets x seq x nfe) is
    captured on a background thread; ``/readyz`` turns 200 once it is in
    (``--no-warm``: ready at bind, first requests capture their graphs)."""
    cfg = _engine_config(
        args, per_sample=True, fused=True, warmup_seq_lens=(args.seq,)
    )
    engine = build_engine(dlm, linear_schedule(), cfg)
    policy = SchedulerPolicy(
        max_wait_ms=args.max_wait_ms,
        target_occupancy=args.occupancy,
        max_queue_rows=(
            args.max_queue_rows if args.max_queue_rows > 0 else None
        ),
    )
    kw = warmup_kwargs(cfg)
    door = serve_frontdoor(
        engine, policy, host=args.host, port=args.port,
        warmup=(
            {**kw, "solvers": (args.solver,)} if kw is not None else None
        ),
    )
    # machine-parsable sentinel: bound is not ready (poll /readyz for that)
    print(f"FRONTDOOR READY {door.url}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        door.stop()


def run_connect(args) -> None:
    """Wire client of a running ``--listen`` server; needs no model."""
    client = FrontDoorClient(args.connect, timeout=args.timeout)
    lats_ms = []
    for i in range(args.requests):
        t0 = time.perf_counter()
        res = client.sample(SampleRequest(
            batch=args.batch, seq_len=args.seq, nfe=args.nfe,
            solver=args.solver, seed=args.seed + i,
        ))
        lats_ms.append((time.perf_counter() - t0) * 1e3)
        x0 = res.x0.float()
        print(
            f"req[{i}] x0 {tuple(x0.shape)} via {args.solver} nfe={args.nfe} "
            f"| wire={lats_ms[-1]:.1f}ms engine_wall={res.info[K.WALL_S]:.2f}s "
            f"(mean {float(x0.mean()):+.4f}, std {float(x0.std()):.4f})"
        )
    print(
        f"connect: {args.requests} req | "
        f"p50={np.percentile(lats_ms, 50):.1f}ms "
        f"p99={np.percentile(lats_ms, 99):.1f}ms"
    )


def build_parser() -> argparse.ArgumentParser:
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
    ap.add_argument(
        "--continuous", action="store_true",
        help="serve a simulated open-loop Poisson stream through the "
        "continuous-batching scheduler (diffusion mode only)",
    )
    ap.add_argument(
        "--listen", action="store_true",
        help="run the HTTP front door over the continuous-batching "
        "scheduler (diffusion mode only); prints 'FRONTDOOR READY <url>' "
        "once bound",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument(
        "--port", type=int, default=0,
        help="--listen port (0 = ephemeral, reported in the ready line)",
    )
    ap.add_argument(
        "--connect", default=None, metavar="URL",
        help="act as a wire client against a running --listen server "
        "(diffusion mode only; no local model needed)",
    )
    ap.add_argument(
        "--timeout", type=float, default=None,
        help="--connect per-request socket timeout in seconds",
    )
    ap.add_argument(
        "--max-queue-rows", type=int, default=4096,
        help="--listen admission bound per fuse-group queue (HTTP 429 "
        "past it; default 4096, <= 0 for unbounded)",
    )
    ap.add_argument(
        "--no-warm", dest="warm", action="store_false",
        help="skip capturing the bucket-graph grid (--listen boots ready "
        "at once; first requests capture their own graphs)",
    )
    ap.add_argument(
        "--warmup-nfes", default=None,
        help="comma-separated NFE list the warmup grid covers (default: "
        "--nfe only)",
    )
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument(
        "--mix", default=None,
        help="comma-separated registry solvers to cycle the --continuous "
        "stream through (per-request routing in one engine), e.g. "
        "'era,ddim,dpm_solver_pp2m'",
    )
    ap.add_argument("--rate", type=float, default=20.0, help="arrivals/s")
    ap.add_argument(
        "--batch-buckets", default="1,8,64",
        help="comma-separated batch ladder of the fused "
        "(--continuous/--listen) engine",
    )
    ap.add_argument(
        "--seq-buckets", default=None,
        help="comma-separated seq-bucket ladder of the fused engine "
        "(mixed-seq-len fusion with padding masks), e.g. '32,64'",
    )
    ap.add_argument(
        "--seq-mix-lens", default=None,
        help="comma-separated seq_lens the --continuous stream cycles "
        "through (default: --seq only)",
    )
    ap.add_argument(
        "--nfe-buckets", default=None,
        help="comma-separated NFE-bucket ladder of the fused engine "
        "(mixed-NFE fusion with per-row step masks; requests above the "
        "top bucket are rejected), e.g. '12,25'",
    )
    ap.add_argument(
        "--nfe-mix-nfes", default=None,
        help="comma-separated NFE budgets the --continuous stream cycles "
        "through (default: --nfe only)",
    )
    ap.add_argument("--max-wait-ms", type=float, default=25.0)
    ap.add_argument(
        "--occupancy", type=float, default=1.0,
        help="launch a batch early once this fraction of the largest "
        "bucket is pending",
    )
    return ap


def main(argv: list[str] | None = None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    serving = args.continuous or args.listen or args.connect
    if serving and args.mode != "diffusion":
        ap.error("--continuous/--listen/--connect require --mode diffusion")
    if args.connect:
        run_connect(args)
        return
    if args.arch not in arch_names():
        ap.error(f"unknown architecture {args.arch!r}; known: {arch_names()}")
    if args.mode == "ar":
        run_ar(args)
        return
    cfg = get_config(args.arch, smoke=args.smoke)
    dlm = DiffusionLM(cfg, device=args.device, seed=args.seed)
    if args.listen:
        run_listen(dlm, args)
    elif args.continuous:
        run_continuous(dlm, args)
    else:
        run_diffusion(dlm, args)


if __name__ == "__main__":
    main()
