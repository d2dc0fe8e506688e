"""Dry run: count every (architecture x input shape) program on a layout of
H100s (port of ``repro.launch.dryrun``).

The reference lowers and compiles each program on a TPU production mesh
and records XLA's cost and memory analysis.  Here each program is built on
``meta`` (:func:`repro_torch.launch.specs.build_program`) and run once
under :class:`~repro_torch.launch.op_count.OpCounter`, so nothing is
allocated on any device.  Each combination writes one JSON under
``artifacts/dryrun_torch/`` with:

* ``flops`` (the attention as dense Sq×Sk products) and ``kept_flops``
  (only the pairs the masks keep), and ``bytes`` (an upper bound on HBM
  traffic, see :mod:`~repro_torch.launch.op_count`), for the whole program;
* the parameter, optimizer, cache and batch bytes each device holds under
  :class:`~repro_torch.parallel.sharding.ShardingRules` (fsdp for the
  train step, as the reference) on the layout, and whether that state fits
  one H100's 80 GB (activations are not in it);
* on a 1x1 layout only, the two roofline terms of the whole program on one
  H100: FLOPs / 989e12 and bytes / 3.35e12 (seconds of a bound, not a
  time: no time measured on a card goes in these files).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape decode_32k --mesh 1x1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --solver-program \\
        --arch qwen2-1.5b --batch 8 --seq 256

``--solver-program`` counts a whole sampling request instead: one solver
program (ERA by default, nfe 10) at a batch and sequence length.  The
reference's ``make_production_mesh`` (TPU v5e pods) has no counterpart:
``--mesh DxM`` is a layout of H100s.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import torch

from repro_torch.configs import INPUT_SHAPES, arch_names, get_config
from repro_torch.launch.mesh import (
    HBM_BW,
    HBM_BYTES,
    PEAK_FLOPS_BF16,
    Mesh,
    parse_layout,
)
from repro_torch.launch.op_count import OpCounter
from repro_torch.launch.specs import Program, build_program
from repro_torch.parallel.sharding import ShardingRules, dp_size, shard_bytes

OUT_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def _layout(mesh: Mesh) -> str:
    return f"{dp_size(mesh)}x{mesh.shape.get('model', 1)}"


def _leaves(tree, prefix="", leaf=torch.Tensor):
    """(dotted key, leaf) of a nested dict, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else str(k), leaf)
    elif isinstance(tree, leaf):
        yield prefix, tree


def state_bytes(program: Program, rules: ShardingRules) -> dict:
    """Bytes each device holds of the program's weights and state."""
    mesh = rules.mesh
    named = dict(program.model.named_parameters())
    specs = rules.param_pspec(named)
    out = {"params": sum(shard_bytes(t.shape, t.element_size(), specs[n], mesh)
                         for n, t in named.items())}
    if "opt" in program.state:
        st = program.state["opt"]
        ospec = rules.opt_pspec(st)
        out["opt"] = sum(shard_bytes(t.shape, t.element_size(), ospec[m][n], mesh)
                         for m in ("m", "v") for n, t in st[m].items())
    if "cache" in program.state:
        cache = program.state["cache"]
        out["cache"] = sum(
            shard_bytes(t.shape, t.element_size(), spec, mesh)
            for (_, t), (_, spec) in zip(_leaves(cache),
                                         _leaves(rules.cache_pspec(cache), leaf=tuple)))
    bspec = rules.batch_pspec(program.state["batch"])
    out["batch"] = sum(shard_bytes(t.shape, t.element_size(), bspec[n], mesh)
                       for n, t in program.state["batch"].items())
    out["total"] = sum(out.values())
    return out


def count(fn, *args) -> tuple[dict, float]:
    """Run ``fn(*args)`` once under the counter; (summary, wall seconds)."""
    t0 = time.perf_counter()
    with OpCounter() as c:
        fn(*args)
    return c.summary(), time.perf_counter() - t0


def count_program(program: Program) -> tuple[dict, float]:
    """A program's counts: ``fn`` run once and counted ``repeat`` times
    (equal microbatches), then ``tail``; (summary, wall seconds)."""
    t0 = time.perf_counter()
    c = OpCounter()
    with c:
        program.fn(*program.args)
    c.scale(program.repeat)
    if program.tail is not None:
        with c:
            program.tail()
    return c.summary(), time.perf_counter() - t0


def _roofline(rec: dict, mesh: Mesh) -> None:
    if mesh.size == 1:
        rec["roofline_bound_s"] = {
            "flops_s": rec["flops"] / PEAK_FLOPS_BF16,
            "bytes_s": rec["bytes"] / HBM_BW,
            "peaks": {"flops_per_s": PEAK_FLOPS_BF16, "bytes_per_s": HBM_BW},
        }


def _write(rec: dict, out_dir, name: str) -> None:
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(Path(out_dir) / name, "w") as f:
        json.dump(rec, f, indent=1)


def run_one(arch: str, shape_name: str, mesh: Mesh | str = "1x1",
            out_dir=OUT_DIR) -> dict:
    """Count one (arch, shape) program on ``mesh`` (a layout ``"DxM"`` or
    an abstract :class:`Mesh`); write and return its record."""
    mesh = parse_layout(mesh) if isinstance(mesh, str) else mesh
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    program = build_program(cfg, shape, dp=dp_size(mesh))
    rules = ShardingRules(cfg, mesh, fsdp=program.name == "train_step")
    counts, wall = count_program(program)
    per_device = state_bytes(program, rules)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": _layout(mesh),
        "entry": program.name, "num_devices": mesh.size,
        "microbatches": program.repeat, **counts,
        "state_bytes_per_device": per_device,
        "fits_80gb": per_device["total"] <= HBM_BYTES,
        "count_s": wall, "ok": True,
    }
    _roofline(rec, mesh)
    _write(rec, out_dir, f"{arch}__{shape_name}__{_layout(mesh)}.json")
    return rec


def run_all(out_dir=OUT_DIR, meshes=("1x1",), resume: bool = True) -> list[dict]:
    """Every (arch, shape, layout); a combination whose JSON says ``ok`` is
    skipped when ``resume``; a failure is written as ``ok: false``."""
    recs = []
    for arch in arch_names():
        for shape in INPUT_SHAPES:
            for layout in meshes:
                path = Path(out_dir) / f"{arch}__{shape}__{layout}.json"
                if resume and path.exists() and json.loads(path.read_text()).get("ok"):
                    print(f"skip {arch} {shape} {layout} (done)")
                    continue
                print(f"=== {arch} {shape} {layout}", flush=True)
                try:
                    recs.append(run_one(arch, shape, layout, out_dir))
                except Exception as e:  # noqa: BLE001 - recorded, the sweep goes on
                    rec = {"arch": arch, "shape": shape, "mesh": layout,
                           "ok": False, "error": f"{type(e).__name__}: {e}"}
                    _write(rec, out_dir, path.name)
                    recs.append(rec)
                    print(f"FAIL {rec['error']}")
    return recs


def run_solver_program(arch: str, mesh: Mesh | str = "1x1", out_dir=OUT_DIR,
                       solver: str = "era", nfe: int = 10, batch: int = 32,
                       seq: int = 2048) -> dict:
    """Count one whole sampling request: the solver program's loop over a
    (batch, seq) latent on a meta denoiser of ``arch`` (serving weights),
    ``nfe`` denoiser evaluations; one evaluation alone beside it."""
    from repro_torch.core import ERAConfig, default_config, get_program, linear_schedule
    from repro_torch.models.diffusion import DiffusionLM

    mesh = parse_layout(mesh) if isinstance(mesh, str) else mesh
    cfg = get_config(arch)
    dlm = DiffusionLM(cfg, device="meta")
    program = get_program(solver)
    scfg = (ERAConfig(nfe=nfe, k=4, per_sample=True) if solver == "era"
            else default_config(solver, nfe=nfe))
    x = torch.empty((batch, seq, cfg.d_model), dtype=torch.float32, device="meta")
    sched = linear_schedule()

    def sample(x):
        return program.sample_scan(dlm.eps_fn(), x, program.alloc_buffers(x, scfg),
                                   sched, scfg)

    counts, wall = count(sample, x)
    one, _ = count(dlm.eps, x, torch.tensor(0.5))
    rules = ShardingRules(cfg, mesh)
    named = dict(dlm.named_parameters())
    specs = rules.param_pspec(named)
    rec = {
        "arch": arch, "mesh": _layout(mesh), "entry": f"sample_{solver}",
        "solver": solver, "nfe": nfe, "batch": batch, "seq": seq,
        "num_devices": mesh.size, **counts,
        "nfe_flops": one["flops"], "nfe_kept_flops": one["kept_flops"],
        "param_bytes_per_device": sum(
            shard_bytes(t.shape, t.element_size(), specs[n], mesh)
            for n, t in named.items()),
        "count_s": wall, "ok": True,
    }
    _roofline(rec, mesh)
    _write(rec, out_dir, f"solver__{arch}__{solver}__{batch}x{seq}__{_layout(mesh)}.json")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="count every (arch x shape) "
                                 "program on meta: FLOPs, bytes, state a device")
    ap.add_argument("--arch", choices=arch_names())
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="1x1", help="a layout of H100s, DxM")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--solver-program", action="store_true",
                    help="count a whole sampling request instead of a shape")
    ap.add_argument("--solver", default="era")
    ap.add_argument("--nfe", type=int, default=10)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args(argv)
    if args.all:
        recs = run_all(args.out, (args.mesh,), resume=not args.no_resume)
        bad = [r for r in recs if not r["ok"]]
        print(f"{len(recs) - len(bad)} ok, {len(bad)} failed")
        if bad:
            raise SystemExit(1)
        return
    if args.solver_program:
        rec = run_solver_program(args.arch or "qwen2-1.5b", args.mesh, args.out,
                                 solver=args.solver, nfe=args.nfe,
                                 batch=args.batch, seq=args.seq)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape are required (or --all)")
        rec = run_one(args.arch, args.shape, args.mesh, args.out)
    print(json.dumps({k: v for k, v in rec.items() if k != "flops_by_op"}, indent=1))


if __name__ == "__main__":
    main()
