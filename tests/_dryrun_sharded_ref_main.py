"""The reference's partitioned dry-run counts on an eight-device CPU mesh.

Run as a script (prints one JSON object on stdout): it sets
``--xla_force_host_platform_device_count=8`` before jax loads, builds a
2x4 (``data``, ``model``) mesh with ``Auto`` axes, and compiles each smoke
program (batch 4 x 64 positions) with the reference's ``build_program``,
``ShardingRules``, ``shardings_for`` and ``hlo_analysis.analyze``, under
``activation_sharding`` as its dry run does.  The reference's
``make_production_mesh`` builds ``Explicit`` axes on this jax, on which its
``constrain_batch`` raises, so the mesh is built here.  Each record holds
the per-device FLOPs of the partitioned HLO (loops multiplied out), its
collectives (result bytes by kind) and XLA's temp size.
"""

from __future__ import annotations

import json
import os
import sys

ARCHS = ("llama3.2-1b", "deepseek-v2-lite-16b", "hymba-1.5b", "whisper-base")
KINDS = ("train", "prefill", "decode")
BATCH, SEQ = 4, 64


def run() -> dict:
    import jax

    jax.devices()   # the backend is up with 8 devices before any flag changes
    from jax.sharding import AxisType

    from repro.configs import get_config
    from repro.configs.registry import InputShape
    from repro.launch import hlo_analysis
    from repro.launch.dryrun import shardings_for
    from repro.launch.specs import build_program
    from repro.models import build_model
    from repro.parallel.ctx import activation_sharding
    from repro.parallel.sharding import ShardingRules, data_axes

    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        model = build_model(cfg)
        for kind in KINDS:
            prog = build_program(model, InputShape("t", SEQ, BATCH, kind), dp=2)
            rules = ShardingRules(cfg, mesh, fsdp=prog.name == "train_step")
            with mesh, activation_sharding(data_axes(mesh)):
                compiled = (jax.jit(prog.fn, in_shardings=shardings_for(prog, rules))
                            .lower(*prog.args).compile())
            hlo = hlo_analysis.analyze(compiled.as_text())
            out[f"{arch}/{kind}"] = {
                "flops": hlo["flops"],
                "collectives": hlo["collectives"],
                "temp_bytes": int(compiled.memory_analysis().temp_size_in_bytes),
            }
    return out


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    print(json.dumps(run()))
