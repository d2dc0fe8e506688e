"""The port's partitioned dry run (``launch/dryrun.py`` on a layout of more
than one card: DTensor over a fake process group, ``parallel/dtensor.py``'s
local regions) against the reference's partitioned HLO on the CPU.

``_dryrun_sharded_ref_main.py`` compiles the reference's smoke programs
(batch 4 x 64) on an eight-device CPU mesh of 2x4 (``data``, ``model``)
in a subprocess and reads the per-device FLOPs and collectives of the
partitioned HLO; the port counts the same programs as rank 0 of a 2x4
layout runs them.  The FLOPs agree within 2%, exactly but for two terms:
MLA's ``V_PAD`` (``test_torch_dryrun.py``), on one card's share of the
rows and heads, and hymba's train step, 0.6% over (as on one card).  The
collectives agree where both partitions reduce the same sums (the
all-reduces of a dense prefill and decode); a train step's differ by
terms each named in ``test_llama_train_collectives_against_reference``.
A prefill's activation peak is held loosely to XLA's temp size.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.registry import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch import op_count as OC
from repro_torch.launch.mesh import NVLINK_BW, device_mesh, parse_layout
from repro_torch.models import build_model
from test_torch_dryrun import KINDS, SMOKE_ARCHS, v_pad_flops

HERE = Path(__file__).resolve().parent
BATCH, SEQ = 4, 64
DP, TP = 2, 4


@pytest.fixture(scope="module")
def runs():
    """(the reference's partitioned counts, the port's 2x4 record of every
    smoke program): the reference compiles in a subprocess while the port
    counts here."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.Popen([sys.executable, str(HERE / "_dryrun_sharded_ref_main.py")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    counts = {}
    for arch in SMOKE_ARCHS:
        for kind in KINDS:
            counts[arch, kind] = dryrun.count_one(
                get_config(arch, smoke=True), InputShape("t", SEQ, BATCH, kind), "2x4")
            assert not torch.distributed.is_initialized(), (arch, kind)
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1]), counts


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_flops_per_device_match_partitioned_hlo(runs, arch, kind):
    """One card's FLOPs within 2% of the reference's partitioned HLO (V_PAD
    on one card's share: the rows over ``data``, the heads over
    ``model``), exactly but for hymba's train step: a weight gathered by
    mistake, or a replicated product split, would count tp times off."""
    ref, counts = runs
    rec = counts[arch, kind]
    want = ref[f"{arch}/{kind}"]["flops"]
    got = rec["flops_per_device"] + v_pad_flops(
        get_config(arch, smoke=True), BATCH // DP, SEQ, kind) / TP
    assert rec["flops_per_device"] == rec["flops"] and rec["num_devices"] == DP * TP
    assert abs(got / want - 1) < 0.02, (got, want)
    if (arch, kind) != ("hymba-1.5b", "train"):
        assert got == want
    assert rec["kept_flops_per_device"] <= rec["flops_per_device"]
    assert rec["peak_activation_bytes_per_device"] > 0


@pytest.mark.parametrize("kind,bytes_", [("prefill", 327_680), ("decode", 5_120)])
def test_llama_all_reduce_bytes_equal_reference(runs, kind, bytes_):
    """Megatron's count: one (B/dp, S, d) float32 activation reduced after
    the vocab-parallel embedding and after each attention and MLP, five
    in all; the reference's partition and the port's reduce the same."""
    ref, counts = runs
    got = counts["llama3.2-1b", kind]["collectives"]["all-reduce"]
    assert got == ref[f"llama3.2-1b/{kind}"]["collectives"]["all-reduce"] == bytes_


def test_llama_train_collectives_against_reference(runs):
    """llama smoke's train step at 2x4 against the reference's partitioned
    HLO, kind by kind.  Both reduce the same forward (five (B/dp, S, d)
    all-reduces), the same three cross-entropy sums and the same
    data-parallel gradients of each layer's weights.  They differ where
    GSPMD communicates more than Megatron's partition, which the port
    follows:

    * GSPMD all-reduces the input gradient of each column-parallel
      product (q, k, v, gate, up: five a layer) apart; the port sums them
      on the rank and all-reduces once at the norm's output (Megatron's
      ``f``, one a norm): 3 L activations fewer;
    * the tied embedding's two gradient terms (the lookup's and the
      head's) are all-reduced over data apart in GSPMD, summed first in
      the port: one local table fewer;
    * the two kv heads over four ranks: GSPMD gathers rank 0's one head in
      the forward and again in the backward, moves half-heads between
      ranks (all-to-all, permute) and all-reduces dK and dV over the two
      ranks that share a head; the port gathers both heads once and
      reduce-scatters their gradient;
    * the gradient norm: GSPMD reduces one partial sum of squares for each
      of the eight weights it splits over model (the embedding, seven a
      layer stacked over the layers), the port one."""
    ref, counts = runs
    want = ref["llama3.2-1b/train"]["collectives"]
    got = counts["llama3.2-1b", "train"]["collectives"]
    cfg = get_config("llama3.2-1b", smoke=True)
    n, rows, hd = cfg.num_layers, BATCH // DP * SEQ, cfg.resolved_head_dim
    act = rows * cfg.d_model * 4
    table = cfg.padded_vocab // TP * cfg.d_model * 4
    dkv = n * 2 * rows * hd * 4               # one kv head's dK and dV a layer
    assert want["all-reduce"] - got["all-reduce"] == 3 * n * act + table + dkv + 4 * 7
    assert want["all-gather"] == 2 * n * 2 * rows * hd * 4
    assert got["all-gather"] == n * 2 * rows * cfg.num_kv_heads * hd * 4
    assert got["reduce-scatter"] == n * 2 * rows * (cfg.num_kv_heads * hd // TP) * 4
    assert set(got) == {"all-reduce", "all-gather", "reduce-scatter"}
    assert {"all-to-all", "collective-permute"} <= set(want)


#: how far a prefill's activation peak may sit from XLA's temp size
PREFILL_TEMP_FACTOR = 1.5


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_prefill_peak_near_reference_temp(runs, arch):
    """One card's activation peak of a prefill at 2x4 within a factor of
    1.5 of the temp size XLA assigns the reference's partitioned prefill:
    both are the most that a forward's transient buffers hold at once
    (XLA's by buffer liveness, the port's by the eager allocations), and
    they differ by what XLA fuses away and by the port's attention
    handlers (0.77-1.02 of it measured).  The train step and the decode
    step are not held to it: there the two differ by up to 6x and 70x
    (XLA's temp of a decode step is far above its activations)."""
    ref, counts = runs
    got = counts[arch, "prefill"]["peak_activation_bytes_per_device"]
    want = ref[f"{arch}/prefill"]["temp_bytes"]
    assert 1 / PREFILL_TEMP_FACTOR < got / want < PREFILL_TEMP_FACTOR, (got, want)


def _param_bytes(cfg) -> int:
    from repro_torch.launch.train import train_config

    model = build_model(train_config(cfg), device="meta")
    return sum(p.numel() * p.element_size() for p in model.parameters())


def test_dense_train_step_collectives_equal_hand_formula():
    """llama smoke's train step (batch 4 x 64, float32 weights):

    * data parallel (2x1): each parameter's float32 gradient all-reduced
      once before the update, and the loss's sum over the rows (a float32);
    * tensor parallel (1x2): the residual stream (B, S, d) all-reduced at
      each norm's input in the forward (after the vocab-parallel embedding,
      each attention, each MLP: 5) and at each norm's output in the
      backward (Megatron's f: 5); the vocab-parallel cross-entropy's three
      (B, S - 1) sums (max, exponentials, the target's logit); and the
      gradient norm's sum of squares (one float32)."""
    cfg = get_config("llama3.2-1b", smoke=True)
    shape = InputShape("t", SEQ, BATCH, "train")
    dp = dryrun.count_one(cfg, shape, "2x1")
    assert dp["collectives"] == {"all-reduce": _param_bytes(cfg) + 4}
    tp = dryrun.count_one(cfg, shape, "1x2")
    act = BATCH * SEQ * cfg.d_model * 4
    rows = BATCH * (SEQ - 1) * 4
    assert tp["collectives"] == {"all-reduce": 10 * act + 3 * rows + 4}
    assert tp["collective_bytes_total"] == 10 * act + 3 * rows + 4


def test_mlp_peak_equals_hand_formula():
    """x (n, d) @ w1 (d, f), tanh, @ w2 (f, d), summed, backward.  The peak
    is in the backward, at tanh's: the tanh output (saved for it), the
    gradient reaching it and the one leaving it (3 n f floats), w2's
    gradient (f d), the loss and its seed gradient (two scalars); x, w1 and
    w2 are state and not in it; views (the seed's expand, the
    transposes) count once."""
    n, d, f = 64, 16, 32
    x = torch.empty(n, d, device="meta")
    w1 = torch.empty(d, f, device="meta", requires_grad=True)
    w2 = torch.empty(f, d, device="meta", requires_grad=True)
    with OC.OpCounter() as c:
        (torch.tanh(x @ w1) @ w2).sum().backward()
    assert c.peak_bytes == 4 * (3 * n * f + f * d + 2)
    # after it: w1's and w2's gradients, which the caller keeps
    assert c.live_bytes == 4 * (d * f + f * d)


def test_activation_peak_falls_with_tensor_parallelism():
    """A dense prefill's per-card activation peak at 1x4 is below one
    card's (the heads, the MLP and the logits split four ways)."""
    cfg = get_config("llama3.2-1b", smoke=True)
    shape = InputShape("t", SEQ, BATCH, "prefill")
    one = dryrun.count_one(cfg, shape, "1x1")
    four = dryrun.count_one(cfg, shape, "1x4")
    assert four["peak_activation_bytes_per_device"] < one["peak_activation_bytes_per_device"]
    assert one["collectives"] == {} and one["flops_per_device"] == one["flops"]
    assert four["collectives"]["all-reduce"] > 0


def test_count_train_step_counts_the_diffusion_step():
    """``count_train_step`` (the step ``chip_smoke.py`` holds to the card's
    memory) on one card: the state it is handed is the float32 weights,
    AdamW's two moments and step, and the latents; work and a peak, no
    collective."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    rec = dryrun.count_train_step(cfg, 2, 16)
    held = rec["state_bytes_per_device"]
    assert rec["entry"] == "diffusion_train_step" and rec["collectives"] == {}
    assert held["opt"] == 2 * held["params"] + 4
    assert held["batch"] == 2 * 16 * cfg.d_model * 4
    assert held["total"] == held["params"] + held["opt"] + held["batch"]
    assert rec["flops_per_device"] > 0 and rec["peak_activation_bytes_per_device"] > 0


def test_fake_group_is_torn_down_on_error():
    with pytest.raises(ValueError, match="inside"):
        with device_mesh(parse_layout("2x4")) as dm:
            assert dm.mesh_dim_names == ("data", "model") and dm.size() == 8
            assert torch.distributed.is_initialized()
            raise ValueError("inside")
    assert not torch.distributed.is_initialized()


def test_cli_writes_the_partitioned_keys(tmp_path, capsys):
    dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k", "--mesh", "2x4",
                 "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "qwen2-1.5b__decode_32k__2x4.json").read_text())
    assert '"collectives"' in capsys.readouterr().out
    for key in ("flops_per_device", "kept_flops_per_device", "bytes_per_device",
                "collectives", "collective_bytes_total",
                "peak_activation_bytes_per_device", "state_bytes_per_device"):
        assert key in rec, key
    held = rec["state_bytes_per_device"]["total"]
    assert rec["fits_80gb"] == (held + rec["peak_activation_bytes_per_device"] <= 80e9)
    assert rec["roofline_bound_s"]["collective_s"] == rec["collective_bytes_total"] / NVLINK_BW
    assert not torch.distributed.is_initialized()

    dryrun.main(["--solver-program", "--arch", "qwen2-1.5b", "--mesh", "2x4",
                 "--bf16-buffer", "--nfe", "4", "--batch", "8", "--seq", "16",
                 "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "solver__qwen2-1.5b__era_bf16__8x16__2x4.json")
                     .read_text())
    assert rec["bf16_buffer"] and rec["num_devices"] == 8
    assert rec["collective_bytes_total"] > 0 and rec["peak_activation_bytes_per_device"] > 0
    assert not torch.distributed.is_initialized()
