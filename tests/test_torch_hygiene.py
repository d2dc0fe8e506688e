"""Walls around the port's package boundary and device rules.

* The port (``src/repro_torch``), its examples (``examples/torch_*.py``)
  and ``chip_smoke.py`` import neither JAX nor the reference package
  ``repro`` — checked both by importing every
  module in a fresh interpreter and by scanning the source.
* Nothing falls back silently: without a card, entry points that were not
  asked for the CPU raise (the bucket-graph path and ``warmup()`` too, and
  the launcher's serving modes; ``--connect`` needs no card), the kernel
  modules, the solver core, the attention module and the AR engine hold no
  ``try`` (a CUDA tensor launches its kernel or raises), no ``try`` on the
  executor's graph path swallows an error, and the scheduler's
  ``_run_batches`` and the front door's ``_run_warmup`` only deliver a
  failure (to the chunk's futures, or to ``/readyz``), never run the work
  again on another path.
"""

import ast
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from repro_torch import device as D
from repro_torch.configs import get_config
from repro_torch.core import ERAConfig, get_solver, linear_schedule
from repro_torch.core import era
from repro_torch.launch import serve
from repro_torch.models import DiffusionLM, build_model
from repro_torch.models.attention import check_decode
from repro_torch.serving import (
    BatchedSampler,
    Engine,
    SampleRequest,
    ServeConfig,
)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
SOURCES = (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "examples").glob("torch_*.py")))


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro") or name.startswith("jax")


def test_importing_the_port_loads_no_jax_or_reference():
    script = f"""
import importlib, importlib.util, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", {str(ROOT / "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps({{"imported": names, "loaded": sorted(sys.modules)}}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        env=env, cwd=str(ROOT), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "repro_torch.core.era" in out["imported"]
    assert "repro_torch.kernels.flash_attention" in out["imported"]
    assert "repro_torch.kernels.decode_attention" in out["imported"]
    assert "repro_torch.kernels.gemm" in out["imported"]
    assert "repro_torch.kernels.rownorm" in out["imported"]
    assert "repro_torch.launch.serve" in out["imported"]
    assert "repro_torch.serving.executor" in out["imported"]
    assert "repro_torch.core.program" in out["imported"]
    assert "repro_torch.serving.scheduler" in out["imported"]
    assert "repro_torch.serving.frontdoor" in out["imported"]
    assert "repro_torch.models.moe" in out["imported"]
    assert "repro_torch.models.mla" in out["imported"]
    for name in ("training.optimizer", "training.train_loop",
                 "training.checkpoint", "data.synthetic", "launch.train",
                 "launch.mesh", "launch.specs", "launch.op_count",
                 "launch.dryrun", "parallel.sharding", "parallel.ctx"):
        assert f"repro_torch.{name}" in out["imported"], name
    bad = [m for m in out["loaded"] if _forbidden(m)]
    assert not bad, bad


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


EXECUTOR = PKG / "serving" / "executor.py"
#: the executor's methods a chunk or warmup() runs on the card
GRAPH_PATH = ("run_chunk", "_run_chunk_locked", "_on_card", "_run_blocks",
              "_run_program", "_graph_for", "_capture", "_replay", "warmup")


@pytest.mark.parametrize(
    "path,method",
    [pytest.param(p, None, id=str(p.relative_to(ROOT))) for p in (
        sorted((PKG / "kernels").glob("*.py"))
        + sorted((PKG / "core").glob("*.py"))
        + [PKG / "serving" / "engine.py", PKG / "models" / "attention.py",
           PKG / "models" / "moe.py", PKG / "models" / "mla.py",
           PKG / "models" / "ssm.py", PKG / "launch" / "train.py"]
        # checkpoint.py's one try/finally only removes a temporary file
        + [PKG / "training" / "optimizer.py", PKG / "training" / "train_loop.py"]
        + [PKG / "parallel" / "sharding.py", PKG / "parallel" / "ctx.py",
           PKG / "launch" / "op_count.py", PKG / "launch" / "specs.py"]
        + sorted((PKG / "data").glob("*.py")))]
    + [pytest.param(EXECUTOR, m, id=f"{EXECUTOR.relative_to(ROOT)}::{m}")
       for m in GRAPH_PATH],
)
def test_kernels_and_solver_hold_no_fallback_try(path, method):
    """Whole modules hold no ``try``; on the graph path a ``try`` may only
    record a failure and raise it again (warmup's failed state)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    if method is None:
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), path
        return
    (fn,) = [n for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef) and n.name == method]
    for node in ast.walk(fn):
        if isinstance(node, ast.Try):
            assert not node.orelse, method
            for handler in node.handlers:
                last = handler.body[-1]
                assert isinstance(last, ast.Raise) and last.exc is None, (
                    f"{method}: an except clause that does not re-raise")


#: methods that run a chunk or a warmup on behalf of others, and the one
#: call each makes to do it; a failure may only be handed on
DELIVERY_ONLY = {
    (PKG / "serving" / "scheduler.py", "_run_batches"): "run_chunk",
    (PKG / "serving" / "frontdoor.py", "_run_warmup"): "_warmup_fn",
}
#: what an except clause of those methods may call
DELIVERY_CALLS = {"resolve_future", "type"}


def _call_name(node: ast.Call) -> str:
    f = node.func
    return f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")


@pytest.mark.parametrize(
    "path,method", list(DELIVERY_ONLY),
    ids=[f"{p.relative_to(ROOT)}::{m}" for p, m in DELIVERY_ONLY])
def test_failures_are_delivered_not_retried(path, method):
    """The scheduler's ``_run_batches`` and the front door's
    ``_run_warmup`` run their work once (one call site), and an except
    clause there only hands the error on: it calls nothing but
    ``resolve_future`` (and ``type``, for a message), and runs no work."""
    tree = ast.parse(path.read_text(), filename=str(path))
    (fn,) = [n for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef) and n.name == method]
    work = DELIVERY_ONLY[(path, method)]
    calls = [_call_name(n) for n in ast.walk(fn) if isinstance(n, ast.Call)]
    assert calls.count(work) == 1, (method, calls)
    tries = [n for n in ast.walk(fn) if isinstance(n, ast.Try)]
    assert len(tries) == 1
    (body_call,) = [_call_name(n) for stmt in tries[0].body
                    for n in ast.walk(stmt) if isinstance(n, ast.Call)]
    assert body_call == work
    for handler in tries[0].handlers:
        names = {_call_name(n) for stmt in handler.body
                 for n in ast.walk(stmt) if isinstance(n, ast.Call)}
        assert names <= DELIVERY_CALLS, (method, names)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    cfg = get_config("qwen2-1.5b", smoke=True)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            D.resolve_device(dev)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffusionLM(cfg)
    x = torch.randn(1, 4, 8)
    eps = lambda x, t: x  # noqa: E731
    with pytest.raises(RuntimeError, match="no CUDA device"):
        era.sample(eps, x, linear_schedule(), ERAConfig(nfe=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_solver("era")(eps, x, linear_schedule(), ERAConfig(nfe=4))


def test_graph_path_and_warmup_raise_without_a_card(no_card):
    """An engine whose denoiser sits on the card neither warms up nor runs
    a chunk without one (no eager or CPU fallback); an engine built on the
    CPU validates its warmup grid and drains eagerly."""
    card = types.SimpleNamespace(
        device=torch.device("cuda"), supports_length_masking=True,
        config=types.SimpleNamespace(d_model=8),
    )
    eng = BatchedSampler(card, linear_schedule(), seq_buckets=(4,),
                         nfe_buckets=(8,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.warmup()
    eng.submit(SampleRequest(batch=1, seq_len=4, nfe=6))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.drain()
    assert eng.compile_cache() == {}

    cfg = get_config("qwen2-1.5b", smoke=True).with_(num_layers=1)
    cpu = BatchedSampler(DiffusionLM(cfg, device="cpu"), linear_schedule(),
                         batch_buckets=(2,), seq_buckets=(4,), nfe_buckets=(6,))
    assert cpu.warmup()["programs"] == 1 and cpu.compile_cache() == {}
    t = cpu.submit(SampleRequest(batch=1, seq_len=3, nfe=5))
    assert cpu.drain()[t].x0.shape == (1, 3, cfg.d_model)


def test_cpu_is_only_taken_when_asked(no_card):
    cfg = get_config("qwen2-1.5b", smoke=True)
    assert D.resolve_device("cpu").type == "cpu"
    assert DiffusionLM(cfg, device="cpu").device.type == "cpu"


def test_ar_entry_points_raise_without_a_card(no_card):
    cfg = get_config("qwen2-1.5b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, device="cuda")
    for mode in ("ar", "diffusion"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--smoke", "--mode", mode])


@pytest.mark.parametrize("flag", ["--continuous", "--listen"])
def test_serving_modes_raise_without_a_card(no_card, flag):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--mode", "diffusion", flag, "--requests", "1"])


def test_serving_modes_take_the_cpu_only_when_asked(no_card, capsys):
    serve.main(["--smoke", "--device", "cpu", "--mode", "diffusion",
                "--continuous", "--requests", "2", "--rate", "1000",
                "--seq", "4", "--nfe", "5", "--batch-buckets", "2"])
    assert "continuous[era]: 2 req" in capsys.readouterr().out


def test_connect_needs_no_card_and_no_model(no_card, capsys, monkeypatch):
    """``--connect`` builds no model: it runs without a card and without
    ``--device``, against a server on the CPU."""
    from repro_torch.serving import SchedulerPolicy, serve_frontdoor

    cfg = get_config("qwen2-1.5b", smoke=True).with_(num_layers=1)
    engine = BatchedSampler(DiffusionLM(cfg, device="cpu"), linear_schedule(),
                            batch_buckets=(2,))
    door = serve_frontdoor(engine, SchedulerPolicy(max_wait_ms=1.0))
    try:
        built = []
        monkeypatch.setattr(serve, "DiffusionLM",
                            lambda *a, **k: built.append(a))
        serve.main(["--mode", "diffusion", "--connect", door.url,
                    "--requests", "2", "--batch", "2", "--seq", "4",
                    "--nfe", "5", "--timeout", "60"])
    finally:
        door.stop()
    out = capsys.readouterr().out
    assert "req[1] x0 (2, 4, 128)" in out and "connect: 2 req" in out
    assert built == []


def test_ar_path_takes_the_cpu_only_when_asked(no_card, capsys):
    cfg = get_config("qwen2-1.5b", smoke=True)
    model = build_model(cfg, device="cpu")
    assert model.device.type == "cpu"
    toks = Engine(model, ServeConfig(max_len=16)).generate(
        torch.zeros(1, 4, dtype=torch.int32), 3
    )
    assert toks.device.type == "cpu" and toks.shape == (1, 3)
    serve.main(["--smoke", "--device", "cpu", "--gen", "2"])
    assert capsys.readouterr().out.startswith("generated (4, 2)")


@pytest.mark.parametrize("impl,ok", [
    ("auto", True), ("flash", True), ("naive", False), ("chunked", False),
])
def test_cuda_decode_takes_the_decode_kernel(impl, ok):
    """A CUDA-tensor decode takes the decode kernel: naming a plain impl for
    it raises, and so does a softcap (on any device: neither the kernel nor
    its plain version has one).  CPU tensors take the plain version under
    any impl."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    if ok:
        check_decode(impl, cuda, 0.0)
    else:
        with pytest.raises(ValueError, match="CPU tensors"):
            check_decode(impl, cuda, 0.0)
    check_decode(impl, cpu, 0.0)
    for dev in (cuda, cpu):
        with pytest.raises(ValueError, match="softcap"):
            check_decode(impl if ok else "auto", dev, 30.0)


def test_training_raises_without_a_card(no_card):
    """The training launcher and the trainer's models need the card unless
    the CPU is asked for."""
    from repro_torch.launch import train as launch_train

    for flag in ([], ["--diffusion"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_train.main(["--smoke", "--steps", "1", *flag])
    cfg = get_config("qwen2-1.5b", smoke=True)
    for diffusion in (True, False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_train.setup(cfg, diffusion=diffusion, steps=1, batch=1, seq=4)
        step, _ = launch_train.setup(cfg, diffusion=diffusion, steps=1,
                                     batch=1, seq=4, device="cpu")
        assert step.module.device.type == "cpu"


def test_flash_backward_launch_has_no_fallback():
    """The backward's launch path (the autograd Function and its wrapper)
    holds no ``try``, and a call at a pair without an instance (forward or
    backward: they have the same pairs) raises in the launch checks, before
    any launch."""
    from repro_torch.kernels import flash_attention as kf

    tree = ast.parse((PKG / "kernels" / "flash_attention.py").read_text())
    fns = [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.ClassDef))
           and n.name in ("_FlashAttention", "flash_attention_bwd", "_forward")]
    assert len(fns) == 3
    for fn in fns:
        assert not any(isinstance(n, ast.Try) for n in ast.walk(fn)), fn.name
    x, pos = torch.zeros(1, 2, 1, 96), torch.arange(2, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"head dims \(q/k 96, v 96\) not in"):
        kf._check(x, x, x, pos, pos, None)
    with pytest.raises(ValueError, match="no instance"):
        kf.bwd_cluster_size(1, 1, 2, 1, 2, 96, 132)


def test_chip_smoke_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
        text=True, env=env, cwd=str(ROOT), timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
