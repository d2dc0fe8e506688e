"""The port's engine factory and launcher against the reference's.

``make_solver_config`` gives the reference's config for every solver (a
full ``ERAConfig`` for ``era``, the registry default at ``nfe`` for the
others), ``build_engine`` serves every registry program through the
port's ``BatchedSampler``, and the launcher's diffusion mode runs with
each solver on the CPU.  The launcher's serving modes run at smoke size on
the CPU: ``--continuous`` (one solver, and a mixed stream over seq and NFE
buckets), and ``--listen`` in a subprocess driven by ``--connect`` once it
prints ``FRONTDOOR READY``.
"""

import dataclasses
import os
import queue
import signal
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from repro.serving import EngineConfig as JEngineConfig
from repro.serving import make_solver_config as jmake_solver_config
from repro.serving import warmup_kwargs as jwarmup_kwargs
from repro_torch.core import ERAConfig, linear_schedule, solver_names
from repro_torch.launch import serve
from repro_torch.serving import (
    BatchedSampler,
    EngineConfig,
    SampleRequest,
    build_engine,
    make_solver_config,
    warmup_kwargs,
)
from test_torch_bucketing import OracleDenoiser

ROOT = Path(__file__).resolve().parent.parent


def _fields(cfg) -> dict:
    """A solver config's fields, less the dtype (a jnp and a torch type)
    and the reference's fused-update switch, which the port has no need of."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("solver_dtype", "use_fused_update")}


@pytest.mark.parametrize("solver", solver_names())
def test_make_solver_config_matches_reference(solver):
    for kw in (dict(nfe=10), dict(nfe=7, k=3, lam=2.0, per_sample=False)):
        got = make_solver_config(EngineConfig(solver=solver, **kw))
        want = jmake_solver_config(JEngineConfig(solver=solver, **kw))
        assert type(got).__name__ == type(want).__name__
        assert _fields(got) == _fields(want)
    era = make_solver_config(EngineConfig(solver="era", nfe=7, k=3))
    assert era == ERAConfig(nfe=7, k=3, per_sample=True)


@pytest.mark.parametrize("solver", solver_names())
def test_build_engine_serves_every_program(solver):
    cfg = EngineConfig(solver=solver, nfe=8, batch_buckets=(4,),
                       seq_buckets=(8,), nfe_buckets=(8,))
    engine = build_engine(OracleDenoiser(), linear_schedule(), cfg)
    assert isinstance(engine, BatchedSampler)
    assert engine.solver_config == make_solver_config(cfg)
    assert (engine.batch_buckets, engine.seq_buckets, engine.nfe_buckets) == (
        (4,), (8,), (8,))
    t = engine.submit(SampleRequest(batch=3, seq_len=6, nfe=8, seed=1))
    res = engine.drain()[t]
    assert res.x0.shape == (3, 6, OracleDenoiser.D_MODEL)
    assert (res.padded_batch, res.padded_seq_len) == (4, 8)


def test_warmup_policy_matches_reference():
    for kw in (dict(), dict(warmup="grid"), dict(warmup="grid", nfe=6),
               dict(warmup="grid", nfe_buckets=(10, 20)),
               dict(warmup="grid", warmup_nfes=(4, 8), warmup_seq_lens=(16,))):
        assert warmup_kwargs(EngineConfig(**kw)) == jwarmup_kwargs(
            JEngineConfig(**kw))
    with pytest.raises(ValueError, match="warmup must be one of"):
        build_engine(OracleDenoiser(), linear_schedule(),
                     EngineConfig(warmup="eager"))
    cfg = EngineConfig(warmup="grid", seq_buckets=(8,))
    engine = build_engine(OracleDenoiser(), linear_schedule(), cfg)
    report = engine.warmup(**warmup_kwargs(cfg))
    assert report["programs"] == len(cfg.batch_buckets)


@pytest.mark.parametrize("solver", solver_names())
def test_launcher_diffusion_mode_runs_each_solver(solver, capsys):
    serve.main(["--mode", "diffusion", "--device", "cpu", "--smoke",
                "--solver", solver, "--batch", "2", "--seq", "8", "--nfe", "6"])
    out = capsys.readouterr().out
    assert out.startswith(f"sampled latents (2, 8, 128) via {solver} nfe=6")


def test_launcher_rejects_an_unknown_solver(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--mode", "diffusion", "--device", "cpu", "--smoke",
                    "--solver", "nope"])
    assert "invalid choice" in capsys.readouterr().err


def test_launcher_module_entry_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
         "diffusion", "--device", "cpu", "--smoke", "--solver",
         "dpm_solver_pp2m"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "via dpm_solver_pp2m nfe=10" in proc.stdout


@pytest.mark.parametrize("extra,label", [
    ([], "era"),
    (["--mix", "era,ddim", "--seq-buckets", "4,8", "--seq-mix-lens", "3,8",
      "--nfe-buckets", "8", "--nfe-mix-nfes", "6,8"], "era,ddim"),
], ids=["one-solver", "mixed"])
def test_launcher_continuous_mode(extra, label, capsys):
    out = serve.run_continuous(
        serve.DiffusionLM(serve.get_config("qwen2-1.5b", smoke=True),
                          device="cpu"),
        serve.build_parser().parse_args(
            ["--mode", "diffusion", "--continuous", "--requests", "6",
             "--rate", "500", "--seq", "8", "--nfe", "6",
             "--batch-buckets", "1,4", "--max-wait-ms", "5", *extra]),
    )
    text = capsys.readouterr().out
    assert "warmup: " in text
    assert f"continuous[{label}]: 6 req @ 500.0/s" in text
    assert out["submitted"] == out["rows"] == 6
    assert 1 <= out["batches"] <= 6 and out["p99_ms"] >= out["p50_ms"] > 0


def test_launcher_serving_flags():
    """The serving modes need the diffusion mode; the reference's
    ``--compile-cache-dir`` has no counterpart and is refused, not
    ignored."""
    for flag in (["--continuous"], ["--listen"], ["--connect", "http://x:1"]):
        with pytest.raises(SystemExit):
            serve.main(["--mode", "ar", "--device", "cpu", "--smoke", *flag])
    with pytest.raises(SystemExit):
        serve.main(["--mode", "diffusion", "--listen", "--compile-cache-dir",
                    "cache"])
    args = serve.build_parser().parse_args(["--no-warm"])
    assert args.warm is False
    cfg = serve._engine_config(
        serve.build_parser().parse_args(["--seq", "256"]), per_sample=True,
        fused=True, warmup_seq_lens=(256,))
    assert cfg.batch_buckets == (1, 8, 64) and cfg.warmup == "grid"
    assert warmup_kwargs(cfg) == {"nfes": (10,), "seq_lens": (256,)}


def test_launcher_listen_and_connect(capsys):
    """``--listen`` in a subprocess prints ``FRONTDOOR READY <url>``; the
    ``--connect`` client samples through it; SIGINT stops it cleanly."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.launch.serve", "--mode",
         "diffusion", "--device", "cpu", "--smoke", "--listen", "--port", "0",
         "--seq", "8", "--nfe", "6", "--batch-buckets", "1,2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(ROOT),
    )
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(line) for line in proc.stdout], daemon=True)
    reader.start()
    try:
        url = None
        while url is None:
            line = lines.get(timeout=240)
            if line.startswith("FRONTDOOR READY "):
                url = line.split()[-1]
        serve.main(["--mode", "diffusion", "--connect", url, "--requests",
                    "2", "--batch", "2", "--seq", "8", "--nfe", "6",
                    "--timeout", "120"])
        out = capsys.readouterr().out
        assert "req[0] x0 (2, 8, 128) via era nfe=6" in out
        assert "connect: 2 req" in out
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        reader.join(timeout=10)
