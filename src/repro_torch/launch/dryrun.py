"""Dry run: count every (architecture x input shape) program on a layout of
H100s (port of ``repro.launch.dryrun``).

The reference lowers and compiles each program on a TPU production mesh
and records XLA's cost and memory analysis of the partitioned program.
Here each program is built on ``meta``
(:func:`repro_torch.launch.specs.build_program`) and run once under
:class:`~repro_torch.launch.op_count.OpCounter`, so nothing is allocated
on any device.  On a layout of more than one card (``--mesh DxM``) the
program's state is first placed on a fake ``DeviceMesh`` of that shape
(:func:`~repro_torch.launch.mesh.device_mesh`) by
:class:`~repro_torch.parallel.sharding.ShardingRules` (fsdp for the train
step, as the reference) and the program runs as DTensors: what is counted
is the partitioned program as one card (rank 0) runs it, the counterpart
of the reference's partitioned HLO.  Each combination writes one JSON
under ``artifacts/dryrun_torch/`` with:

* ``flops`` (the attention as dense Sq×Sk products) and ``kept_flops``
  (only the pairs the masks keep), and ``bytes`` (an upper bound on HBM
  traffic, see :mod:`~repro_torch.launch.op_count`), of one card's share,
  also under ``flops_per_device``, ``kept_flops_per_device`` and
  ``bytes_per_device`` (on a 1x1 layout the whole program);
* ``collectives``, the result bytes of each kind of collective one card
  issues, and their sum ``collective_bytes_total`` (none on 1x1);
* ``peak_activation_bytes_per_device``: the most bytes the program's own
  allocations hold at once on one card (activations, the tensors saved
  for the backward, gradients, temporaries);
* ``state_bytes_per_device``, the parameter, optimizer, cache and batch
  bytes each card holds under the rules, and ``fits_80gb``: whether that
  state plus the activation peak fits one H100's 80 GB;
* ``roofline_bound_s``, the bound terms of one card: FLOPs / 989e12 and
  bytes / 3.35e12, and on a layout of at most 8 cards (one NVLink domain)
  collective bytes / 450e9 (``collective_s``); past 8 cards the bytes only,
  with the reason (seconds of a bound, not a time: no time measured on a
  card goes in these files).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape decode_32k --mesh 2x4
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 1x8
    PYTHONPATH=src python -m repro_torch.launch.dryrun --solver-program \\
        --arch qwen2-1.5b --batch 8 --seq 256 --mesh 2x4 --bf16-buffer

``--solver-program`` counts a whole sampling request instead: one solver
program (ERA by default, nfe 10) at a batch and sequence length, the
backbone placed by the rules, the denoiser's heads replicated and the
latents split over the data axes, as the reference's; ``--bf16-buffer``
keeps ERA's eps history in bfloat16.  The reference's
``make_production_mesh`` (TPU v5e pods) has no counterpart: ``--mesh DxM``
is a layout of H100s.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import time
import warnings
from pathlib import Path

import torch
from torch import Tensor

from repro_torch.configs import INPUT_SHAPES, arch_names, get_config
from repro_torch.launch.mesh import (
    HBM_BW,
    HBM_BYTES,
    NVLINK_BW,
    PEAK_FLOPS_BF16,
    Mesh,
    device_mesh,
    parse_layout,
)
from repro_torch.launch.op_count import OpCounter
from repro_torch.launch.specs import Program, build_program
from repro_torch.parallel import dtensor as DT
from repro_torch.parallel.sharding import (
    ShardingRules,
    distribute,
    dp_size,
    place,
    place_module,
    placements,
    shard_bytes,
)

#: the most cards one NVLink domain (an HGX H100 board) joins
NVLINK_DOMAIN = 8

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


@contextlib.contextmanager
def partitioned(mesh: Mesh, rules: ShardingRules, program: Program | None = None):
    """The block's programs run as rank 0 of ``mesh`` (more than one card:
    a fake ``DeviceMesh``, ``program``'s state placed by ``rules``;
    yields the ``DeviceMesh``), or as they are on one card (yields None)."""
    if mesh.size == 1:
        yield None
        return
    with device_mesh(mesh) as dm, DT.partitioned(), warnings.catch_warnings():
        # a one-element time tensor mixed with DTensors replicates, as meant
        warnings.filterwarnings("ignore", message=".*non-scalar tensor with numel=1")
        if program is not None:
            distribute(program, rules, dm)
        yield dm


def _per_device(counts: dict) -> dict:
    """The counter's summary as a record's per-device keys."""
    out = dict(counts)
    out["peak_activation_bytes_per_device"] = out.pop("peak_bytes")
    for k in ("flops", "kept_flops", "bytes"):
        out[f"{k}_per_device"] = out[k]
    return out


def _roofline(rec: dict, mesh: Mesh) -> None:
    bound = {
        "flops_s": rec["flops_per_device"] / PEAK_FLOPS_BF16,
        "bytes_s": rec["bytes_per_device"] / HBM_BW,
        "peaks": {"flops_per_s": PEAK_FLOPS_BF16, "bytes_per_s": HBM_BW},
    }
    if 1 < mesh.size <= NVLINK_DOMAIN:
        bound["collective_s"] = rec["collective_bytes_total"] / NVLINK_BW
        bound["peaks"]["collective_bytes_per_s"] = NVLINK_BW
    elif mesh.size > NVLINK_DOMAIN:
        bound["collective_note"] = (
            f"{mesh.size} cards span more than one {NVLINK_DOMAIN}-card NVLink "
            f"domain: the collectives cross the network, whose rate this "
            f"layout does not fix; their bytes only")
    rec["roofline_bound_s"] = bound


def _write(rec: dict, out_dir, name: str) -> None:
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(Path(out_dir) / name, "w") as f:
        json.dump(rec, f, indent=1)


def count_one(cfg, shape, mesh: Mesh | str = "1x1") -> dict:
    """The record of one program (``cfg`` at ``shape``, an
    :class:`~repro_torch.configs.registry.InputShape`) on ``mesh``, as one
    card of it runs it: its counts, state and roofline terms."""
    mesh = parse_layout(mesh) if isinstance(mesh, str) else mesh
    program = build_program(cfg, shape, dp=dp_size(mesh))
    rules = ShardingRules(cfg, mesh, fsdp=program.name == "train_step")
    per_device = state_bytes(program, rules)
    with partitioned(mesh, rules, program):
        counts, wall = count_program(program)
    rec = {
        "mesh": _layout(mesh), "entry": program.name, "num_devices": mesh.size,
        "microbatches": program.repeat, **_per_device(counts),
        "state_bytes_per_device": per_device,
        "fits_80gb": (per_device["total"]
                      + counts["peak_bytes"]) <= HBM_BYTES,
        "count_s": wall, "ok": True,
    }
    _roofline(rec, mesh)
    return rec


def run_one(arch: str, shape_name: str, mesh: Mesh | str = "1x1",
            out_dir=OUT_DIR) -> dict:
    """Count one (arch, shape) program on ``mesh`` (a layout ``"DxM"`` or
    an abstract :class:`Mesh`), as one card of it runs it; write and
    return its record."""
    rec = {"arch": arch, "shape": shape_name,
           **count_one(get_config(arch), INPUT_SHAPES[shape_name], mesh)}
    _write(rec, out_dir, f"{arch}__{shape_name}__{rec['mesh']}.json")
    return rec


def run_all(out_dir=OUT_DIR, meshes=("1x1",), resume: bool = True,
            archs=None, shapes=None) -> list[dict]:
    """Every (arch, shape, layout), or those of ``archs`` and ``shapes``;
    a combination whose JSON says ``ok`` is skipped when ``resume``; a
    failure is written as ``ok: false``."""
    recs = []
    for arch in archs or arch_names():
        for shape in shapes or INPUT_SHAPES:
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


def summary_table(out_dir=OUT_DIR) -> str:
    """The (arch, shape) records under ``out_dir`` as a markdown table
    with a column a layout (counts, not times): whether one card's state
    plus activation peak fits 80 GB, those two in GB, and the collective
    GB a card."""
    recs = [json.loads(p.read_text()) for p in sorted(Path(out_dir).glob("*__*__*.json"))]
    recs = [r for r in recs if r.get("ok") and "shape" in r]
    layouts = sorted({r["mesh"] for r in recs},
                     key=lambda m: (int(m.split("x")[0]) * int(m.split("x")[1]), m))
    cells: dict = {}
    for r in recs:
        fits = "fits" if r["fits_80gb"] else "no"
        cells.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = (
            f"{fits} {r['state_bytes_per_device']['total'] / 1e9:.1f}"
            f"+{r['peak_activation_bytes_per_device'] / 1e9:.1f}; "
            f"{r['collective_bytes_total'] / 1e9:.1f}")
    rows = ["| arch | shape | " + " | ".join(layouts) + " |",
            "|" + " --- |" * (2 + len(layouts))]
    for (arch, shape), by in sorted(cells.items()):
        rows.append(f"| {arch} | {shape} | "
                    + " | ".join(by.get(m, "—") for m in layouts) + " |")
    return "\n".join(rows)


def run_solver_program(arch: str, mesh: Mesh | str = "1x1", out_dir=OUT_DIR,
                       solver: str = "era", nfe: int = 10, batch: int = 32,
                       seq: int = 2048, bf16_buffer: bool = False) -> dict:
    """Count one whole sampling request: the solver program's loop over a
    (batch, seq) latent on a meta denoiser of ``arch`` (serving weights),
    ``nfe`` denoiser evaluations; one evaluation alone beside it.  On more
    than one card the backbone is placed by the rules, the denoiser's
    heads replicate, and the latents and the solver's carry split over the
    data axes (:meth:`~repro_torch.core.program.SolverProgram.carry_pspecs`).
    ``bf16_buffer``: ERA keeps its eps history in bfloat16."""
    from repro_torch.core import ERAConfig, default_config, get_program, linear_schedule
    from repro_torch.models.diffusion import DiffusionLM

    mesh = parse_layout(mesh) if isinstance(mesh, str) else mesh
    cfg = get_config(arch)
    dlm = DiffusionLM(cfg, device="meta")
    program = get_program(solver)
    scfg = (ERAConfig(nfe=nfe, k=4, per_sample=True,
                      solver_dtype=torch.bfloat16 if bf16_buffer else torch.float32)
            if solver == "era" else default_config(solver, nfe=nfe))
    x = torch.empty((batch, seq, cfg.d_model), dtype=torch.float32, device="meta")
    sched = linear_schedule()
    rules = ShardingRules(cfg, mesh)
    named = dict(dlm.named_parameters())
    specs = rules.param_pspec(named)
    carry = program.carry_pspecs(scfg, mesh, batch=batch)
    t = torch.tensor(0.5)
    eps = dlm.eps
    with partitioned(mesh, rules) as dm:
        if dm is not None:
            place_module(dlm, specs, dm)
            eps = functools.partial(_on_rows, dlm.eps, dm, placements(carry.x, dm), batch)
            x = DT.local(place(x, carry.x, dm))

        def sample(x):
            return program.sample_scan(lambda x, t: eps(x, t), x,
                                       program.alloc_buffers(x, scfg), sched, scfg)

        counts, wall = count(sample, x)
        one, _ = count(eps, x, t)
    rec = {
        "arch": arch, "mesh": _layout(mesh), "entry": f"sample_{solver}",
        "solver": solver, "nfe": nfe, "batch": batch, "seq": seq,
        "bf16_buffer": bf16_buffer, "num_devices": mesh.size,
        **_per_device(counts),
        "nfe_flops": one["flops"], "nfe_kept_flops": one["kept_flops"],
        "param_bytes_per_device": sum(
            shard_bytes(t.shape, t.element_size(), specs[n], mesh)
            for n, t in named.items()),
        "count_s": wall, "ok": True,
    }
    _roofline(rec, mesh)
    suffix = "bf16" if bf16_buffer else "f32"
    _write(rec, out_dir, f"solver__{arch}__{solver}_{suffix}__{batch}x{seq}"
                         f"__{_layout(mesh)}.json")
    return rec


def count_train_step(cfg, batch: int, seq: int) -> dict:
    """Count one diffusion training step of ``launch/train.py``'s setup
    of ``cfg`` (float32 weights, ``batch`` x ``seq`` latents) on ``meta``
    on one card: its counts, the bytes of the state it is handed (weights,
    AdamW's moments, the batch) and its activation peak (gradients
    included).  This is the step ``chip_smoke.py`` runs on the card, not
    :func:`~repro_torch.launch.specs.build_program`'s LM ``train_step``."""
    from repro_torch.launch.train import setup
    from repro_torch.training import optimizer as opt

    step, _ = setup(cfg, diffusion=True, steps=1, batch=batch, seq=seq, device="meta")
    state = opt.init_state(step.params)
    data = {"latents": torch.empty((batch, seq, cfg.d_model), dtype=torch.float32,
                                   device="meta")}

    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    held = {"params": nbytes(step.params.values()),
            "opt": nbytes([*state["m"].values(), *state["v"].values(), state["step"]]),
            "batch": nbytes(data.values())}
    held["total"] = sum(held.values())
    counts, wall = count(step, state, data, None)
    return {"entry": "diffusion_train_step", "batch": batch, "seq": seq,
            **_per_device(counts), "state_bytes_per_device": held, "count_s": wall}


def _on_rows(fn, dm, pl, batch: int, x: Tensor, t):
    """``fn(x, t)``, a partitioned denoiser, on rank 0's rows ``x`` of a
    ``batch``-row latent placed by ``pl`` (``t`` a scalar, or its rows'
    times): the solver's own math runs on the local rows, as the
    reference's batch-split carry does, and only the denoiser runs as
    DTensors; its result comes back as rank 0's rows."""
    from torch.distributed.tensor import DTensor

    def rows(v):
        shape = (batch, *v.shape[1:])
        return DTensor.from_local(v, dm, pl, run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta").stride())

    t = torch.as_tensor(t, dtype=torch.float32)
    out = fn(rows(x), rows(t) if t.dim() else t)
    return out.redistribute(dm, pl).to_local()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="count every (arch x shape) "
                                 "program on meta as one card of a layout runs "
                                 "it: FLOPs, bytes, collectives, memory")
    ap.add_argument("--arch", help="an arch (with --all: a comma list)")
    ap.add_argument("--shape", help="an input shape (with --all: a comma list)")
    ap.add_argument("--mesh", default="1x1",
                    help="a layout of H100s, DxM (with --all: a comma list)")
    ap.add_argument("--summary", action="store_true",
                    help="print the records under --out as a table")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--solver-program", action="store_true",
                    help="count a whole sampling request instead of a shape")
    ap.add_argument("--solver", default="era")
    ap.add_argument("--nfe", type=int, default=10)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--bf16-buffer", action="store_true",
                    help="ERA's eps history in bfloat16 (--solver-program)")
    args = ap.parse_args(argv)
    archs = None if args.arch is None else args.arch.split(",")
    shapes = None if args.shape is None else args.shape.split(",")
    for name in archs or ():
        if name not in arch_names():
            ap.error(f"--arch {name!r}: not one of {arch_names()}")
    for name in shapes or ():
        if name not in INPUT_SHAPES:
            ap.error(f"--shape {name!r}: not one of {list(INPUT_SHAPES)}")
    if args.summary:
        print(summary_table(args.out))
        return
    if args.all:
        recs = run_all(args.out, args.mesh.split(","), resume=not args.no_resume,
                       archs=archs, shapes=shapes)
        bad = [r for r in recs if not r["ok"]]
        print(f"{len(recs) - len(bad)} ok, {len(bad)} failed")
        if bad:
            raise SystemExit(1)
        return
    if args.solver_program:
        rec = run_solver_program(args.arch or "qwen2-1.5b", args.mesh, args.out,
                                 solver=args.solver, nfe=args.nfe,
                                 batch=args.batch, seq=args.seq,
                                 bf16_buffer=args.bf16_buffer)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape are required (or --all)")
        rec = run_one(args.arch, args.shape, args.mesh, args.out)
    print(json.dumps({k: v for k, v in rec.items() if k != "flops_by_op"}, indent=1))


if __name__ == "__main__":
    main()
