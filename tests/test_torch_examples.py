"""The port's examples (``examples/torch_*.py``) run end to end on the CPU
at their smallest arguments."""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_trains_samples_and_serves(tmp_path):
    out = _example("torch_quickstart").main(
        ["--device", "cpu", "--steps", "8", "--samples", "8", "--seq", "8",
         "--batch", "8", "--ckpt-dir", str(tmp_path)])
    first, last = out["loss"]
    assert last < first
    assert out["x0"].shape == (8, 8, 128) and bool(torch.isfinite(out["x0"]).all())
    assert math.isfinite(out["mean_err"]) and math.isfinite(out["var_err"])
    assert [r.padded_batch for r in out["served"]] == [8] * 4
    assert any(tmp_path.iterdir())     # the checkpoint was written


def test_compare_solvers_scores_every_solver():
    from repro_torch.core import solver_names

    table = _example("torch_compare_solvers").main(
        ["--device", "cpu", "--train-steps", "3", "--nfes", "6", "--ref-nfe", "20",
         "--samples", "4"])
    assert set(table) == set(solver_names())
    assert all(v is None or (math.isfinite(v) and v >= 0)
               for row in table.values() for v in row.values())
    assert table["era"][6] is not None


def test_serve_multi_arch_generates_for_every_family():
    mod = _example("torch_serve_multi_arch")
    out = mod.main(["--device", "cpu", "--gen", "2", "--ring-gen", "34"])
    assert set(mod.ARCHS) <= set(out)
    for label, toks in out.items():
        assert toks.dtype == torch.int32
        assert toks.shape == ((1, 34) if "SWA" in label else (2, 2)), label


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_compare_solvers",
                                  "torch_serve_multi_arch"])
def test_examples_need_a_card_unless_told_cpu(name):
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example(name).main([])
