"""The port's dry run (``launch/{specs,op_count,dryrun}.py``) against the
reference's HLO analysis on the CPU.

The reference compiles each smoke program on the CPU and counts the FLOPs
of every ``dot`` in the HLO, loops multiplied out
(``repro.launch.hlo_analysis.analyze``); the port runs the same program on
``meta`` under its dispatch-mode counter.  They agree within 2%, and
exactly but for two terms:

* ``V_PAD``, by design: the reference's MLA pads V from its head dim
  (32 at smoke size) to the q/k head dim (48) for its shared SDPA, so its
  P·V product (and that product's two gradients) is wider; the port's
  flash kernel has a (q/k, v) head-dim pair.  The test adds that term to
  the port's count and then requires equality.
* hymba's train step counts 0.6% more in the port (3 x 2^20 FLOPs at this
  shape), which this test does not attribute; it is held to the 2%.

A full-width qwen2-1.5b NFE is held exactly to a hand formula.
"""

import json

import jax
import pytest
import torch

from repro.configs import INPUT_SHAPES as JINPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.configs.registry import InputShape as JShape
from repro.launch import hlo_analysis
from repro.launch.specs import build_program as jbuild_program
from repro.launch.specs import decode_slots as jdecode_slots
from repro.launch.specs import decode_window_override as jdecode_window_override
from repro.launch.specs import train_microbatches as jtrain_microbatches
from repro.models import build_model as jbuild_model
from repro_torch.configs import INPUT_SHAPES, arch_names, get_config
from repro_torch.configs.registry import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch import op_count as OC
from repro_torch.launch.specs import (
    build_program,
    decode_slots,
    decode_window_override,
    train_microbatches,
)
from repro_torch.models import DiffusionLM

SMOKE_ARCHS = ["llama3.2-1b", "deepseek-v2-lite-16b", "hymba-1.5b", "whisper-base"]
KINDS = ["train", "prefill", "decode"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_flops_match_reference_hlo(arch, kind):
    """Batch 2 x 64 positions: the counter's FLOPs within 2% of the
    reference's compiled program."""
    jprog = jbuild_program(jbuild_model(jget_config(arch, smoke=True)),
                           JShape("t", 64, 2, kind), dp=1)
    ref = hlo_analysis.analyze(jax.jit(jprog.fn).lower(*jprog.args).compile().as_text())
    prog = build_program(get_config(arch, smoke=True), InputShape("t", 64, 2, kind), dp=1)
    got, _ = dryrun.count_program(prog)
    assert prog.name == jprog.name
    flops = got["flops"] + v_pad_flops(get_config(arch, smoke=True), 2, 64, kind)
    assert abs(flops / ref["flops"] - 1) < 0.02, (flops, ref["flops"])
    if (arch, kind) != ("hymba-1.5b", "train"):
        assert flops == ref["flops"]
    assert got["bytes"] > 0 and got["kept_flops"] <= got["flops"]


def v_pad_flops(cfg, b: int, s: int, kind: str) -> float:
    """V_PAD: the reference's MLA P·V over V padded to the q/k head dim,
    2 B H S^2 (hd_qk - hd_v) a layer and pass; the train step runs it
    three times (forward, and the two gradients of the product); decode
    takes the absorbed form, which has no padding."""
    if cfg.mla is None or kind == "decode":
        return 0.0
    a = cfg.mla
    pad = a.qk_nope_head_dim + a.qk_rope_head_dim - a.v_head_dim
    layers = sum(c for k, c in cfg.blocks if k == "mla_moe")
    return 2.0 * b * cfg.num_heads * s * s * pad * layers * (3 if kind == "train" else 1)


def test_counter_counts_products_forward_and_backward():
    a = torch.empty(8, 16, device="meta", requires_grad=True)
    w = torch.empty(16, 32, device="meta", requires_grad=True)
    with OC.OpCounter() as c:
        (a @ w).sum().backward()
    # forward 2*8*32*16, backward two products of the same size
    assert c.flops == 3 * 2 * 8 * 32 * 16
    with OC.OpCounter() as c:
        torch.einsum("bqd,bkd->bqk", torch.empty(2, 4, 8, device="meta"),
                     torch.empty(2, 6, 8, device="meta"))
    assert c.flops == 2 * 2 * 4 * 6 * 8
    assert c.bytes >= (2 * 4 * 8 + 2 * 6 * 8 + 2 * 4 * 6) * 4


@pytest.mark.parametrize("sq,sk,causal,window,protected,want", [
    (4, 4, True, 0, 0, 10), (4, 4, False, 0, 0, 16), (1, 8, True, 0, 0, 8),
    (6, 6, True, 2, 0, 11), (6, 6, True, 2, 1, 15), (1, 8, True, 3, 2, 5)])
def test_kept_pairs(sq, sk, causal, window, protected, want):
    """Against a brute-force count of the masks' predicates."""
    n = 0
    for i in range(sq):
        p = i + sk - sq
        for j in range(sk):
            ok = (not causal or j <= p) and (
                window == 0 or j > p - window or j < protected)
            n += ok
    assert n == want == OC.kept_pairs(sq, sk, causal=causal, window=window,
                                      protected=protected)


def test_kernel_wrappers_on_meta_charge_the_counter():
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    m = dict(device="meta")
    q = torch.empty(2, 8, 4, 16, **m, requires_grad=True)
    k = torch.empty(2, 8, 2, 16, **m, requires_grad=True)
    v = torch.empty(2, 8, 2, 16, **m, requires_grad=True)
    pos = torch.empty(8, dtype=torch.int32, **m)
    with OC.OpCounter() as c:
        out = flash_attention(q, k, v, pos, pos, causal=True)
        assert out.shape == (2, 8, 4, 16) and out.device.type == "meta"
        out.sum().backward()
    dense = 2 * 2 * 4 * (16 + 16) * 8 * 8
    assert c.attn_flops == 3 * dense
    assert c.attn_kept_flops == 3 * 2 * 2 * 4 * 32 * 36
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    with OC.OpCounter() as c:
        o = decode_attention(torch.empty(2, 1, 4, 16, **m), k.detach(), v.detach(),
                             7, pos)
    assert o.shape == (2, 1, 4, 16) and c.attn_flops == 2 * 2 * 4 * 32 * 8


def test_kernels_reach_the_counter_only_through_its_handlers(monkeypatch):
    """The kernel modules import nothing of the launch layer: the counter
    registers its meta handlers with them, and a meta call with no handler
    raises instead of computing anything."""
    import ast
    from pathlib import Path

    import repro_torch.kernels as KR
    from repro_torch.kernels.era_update import era_update

    for path in Path(KR.__file__).parent.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""])
                assert not any(n.startswith("repro_torch.launch") for n in names), path
    assert set(KR.META_HANDLERS) == {"flash_attention", "decode_attention", "era_update"}
    monkeypatch.delitem(KR.META_HANDLERS, "era_update")
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(RuntimeError, match="META_HANDLERS"):
        era_update(x, torch.empty(3, 2, 8, device="meta"), torch.empty(2, 3, device="meta"),
                   (0, 1, 2), torch.empty(2, 3, device="meta"), (0.0, 0.0, 0.0, 0.0),
                   1.0, 1.0)


def test_qwen2_nfe_equals_the_hand_formula():
    """Full-width qwen2-1.5b, one denoiser evaluation at 8 x 256 on meta:
    2 x (each weight matrix's elements) x tokens for the backbone, in_proj
    and eps_head, 2 x elements for the time MLP (one time row), and the
    dense attention, 4 B S^2 H hd a layer."""
    cfg = get_config("qwen2-1.5b")
    dlm = DiffusionLM(cfg, device="meta")
    b, s = 8, 256
    got, _ = dryrun.count(dlm.eps, torch.empty(b, s, cfg.d_model, device="meta"),
                          torch.tensor(0.5))
    tokens = b * s
    mats = {n: p.numel() for n, p in dlm.named_parameters() if p.dim() == 2}
    per_token = sum(v for n, v in mats.items() if not n.startswith("time_mlp"))
    once = sum(v for n, v in mats.items() if n.startswith("time_mlp"))
    attn = 4 * b * s * s * cfg.num_heads * cfg.resolved_head_dim * cfg.num_layers
    assert got["flops"] == 2 * per_token * tokens + 2 * once + attn
    assert got["attention_flops"] == attn == got["attention_kept_flops"]


def test_era_request_counts_nfe_evaluations():
    rec = dryrun.run_solver_program("qwen2-1.5b", "1x1", out_dir=None, nfe=5,
                                    batch=1, seq=8)
    assert rec["flops"] == 5 * rec["nfe_flops"]
    assert set(rec["roofline_bound_s"]) >= {"flops_s", "bytes_s"}


@pytest.mark.parametrize("name", arch_names())
def test_programs_build_for_all_shapes(name):
    """Every (arch, shape) gets a program with no allocation (meta), as the
    reference's ``tests/test_sharding.py`` checks for its own; the helpers
    equal the reference's."""
    cfg, jcfg = get_config(name), jget_config(name)
    for shape in INPUT_SHAPES.values():
        prog = build_program(cfg, shape)
        assert prog.args and prog.model.embed.device.type == "meta"
        assert prog.name == f"{shape.kind}_step"
        jshape = JINPUT_SHAPES[shape.name]
        assert decode_slots(cfg, shape) == jdecode_slots(jcfg, jshape)
        assert decode_window_override(cfg, shape) == jdecode_window_override(jcfg, jshape)
        assert train_microbatches(cfg, shape, 16) == jtrain_microbatches(jcfg, jshape, 16)
    assert {(s.name, s.seq_len, s.global_batch, s.kind) for s in INPUT_SHAPES.values()} == {
        (s.name, s.seq_len, s.global_batch, s.kind) for s in JINPUT_SHAPES.values()}


def test_run_one_writes_its_record(tmp_path):
    rec = dryrun.run_one("qwen2-1.5b", "decode_32k", "1x1", tmp_path)
    saved = json.loads((tmp_path / "qwen2-1.5b__decode_32k__1x1.json").read_text())
    assert saved["ok"] and saved["entry"] == "decode_step" and saved["flops"] > 0
    per = rec["state_bytes_per_device"]
    # 128 x 32768 slots x 28 layers x K and V x 2 kv heads x 128 x 2 bytes
    assert per["cache"] == 128 * 32768 * 28 * 2 * 2 * 128 * 2 + 28 * 0 + 32768 * 4
    assert not rec["fits_80gb"]
    assert rec["roofline_bound_s"]["flops_s"] == rec["flops"] / 989e12
    eight = dryrun.run_one("qwen2-1.5b", "decode_32k", "8x1", None)
    # every layout has its per-device bound, and its collectives' term
    bound = eight["roofline_bound_s"]
    assert eight["mesh"] == "8x1" and bound["flops_s"] == eight["flops_per_device"] / 989e12
    assert bound["collective_s"] == eight["collective_bytes_total"] / 450e9
    assert eight["state_bytes_per_device"]["cache"] < per["cache"] / 7


def test_cli_smoke(tmp_path, capsys):
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "prefill_32k", "--mesh", "1x1",
                 "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert '"entry": "prefill_step"' in out
    assert (tmp_path / "llama3.2-1b__prefill_32k__1x1.json").exists()
