"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

1. prints the card's name and power limit, builds the kernels from the
   sources in the checkout;
2. holds the Triton ``era_update`` kernel against its plain PyTorch version
   (max abs error <= 1e-5, the reference's fused-step tolerance);
3. holds the CUDA ``flash_attention`` kernel against its plain version
   (all-float32 math) at qwen2-1.5b shapes in bf16 and in the masking,
   softcap, ragged-tile and head-dim variants;
4. serves requests through the port's ``BatchedSampler`` on a full-width
   qwen2-1.5b denoiser (28 layers, d_model 1536, bf16, random seeded
   weights) with ERA at nfe=10, checks the outputs, and checks from the
   kernels' launch counters that the sampling path ran both kernels;
5. prints one ``{"kernels": [...]}`` line with each kernel's launches,
   error and times beside its bound, then the result line.

It imports nothing of the JAX package.  Any failed check raises, so the
script exits non-zero and prints no result line; it also fails when no
CUDA device is present or the port's sources are missing.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet), the denominators of bound_ms
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12

# launches of each kernel per fused batch on the sampling path
NFE = 10
K = 4

# tolerance of the flash kernel against its all-float32 plain version,
# |kernel - plain| <= FLASH_ATOL + FLASH_RTOL * |plain|: both outputs are
# rounded to bf16 (half an ulp each, together at most one ulp, 2^-7
# relative), and the kernel rounds P to bf16 before P.V (at most 2^-9
# relative a term, so at most 2^-9 * max|v| < 2^-6 for |v| < 8)
FLASH_ATOL = 2 ** -6
FLASH_RTOL = 2 ** -7
ERA_TOL = 1e-5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: era_update
# ---------------------------------------------------------------------------


def era_inputs(rows: int, n: int, k: int, cap: int, gen, i: int = 6):
    """Inputs of the ERA step at step ``i``: as ERS selects them, each row's
    bases are strictly increasing entries of [0, i] ending at ``i`` itself,
    and the corrector's history is entries (i, i-1, i-2)."""
    dev = "cuda"
    x = torch.randn(rows, n, generator=gen, device=dev)
    buf = torch.randn(cap, rows, n, generator=gen, device=dev)
    last = torch.full((1,), i, device=dev)
    tau = torch.stack([
        torch.cat([torch.sort(
            torch.randperm(i, generator=gen, device=dev)[: k - 1]).values, last])
        for _ in range(rows)
    ]).to(torch.int32)
    lag_w = torch.randn(rows, k, generator=gen, device=dev)
    cx = torch.rand(rows, generator=gen, device=dev) + 0.5
    ce = torch.randn(rows, generator=gen, device=dev) * 0.1
    return x, buf, tau, (i, i - 1, i - 2), lag_w, cx, ce


def era_bytes(x, tau, hist) -> float:
    """Bytes the step must move: x and each distinct buffer entry a row
    reads (its bases and history, which overlap) once, two outputs once."""
    n = x.shape[1]
    words = sum(1 + len(set(row) | set(hist)) + 2 for row in tau.tolist())
    return 4.0 * n * words


def phase_era(ku):
    from repro_torch.core.era import AM4

    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    cases = {
        "main B=8 N=256*1536": (8, 256 * 1536),
        "ragged B=3 N=1000": (3, 1000),
        "shared one row N=8*256*1536": (1, 8 * 256 * 1536),
    }
    timing = None
    for name, (rows, n) in cases.items():
        x, buf, tau, hist, lag_w, cx, ce = era_inputs(rows, n, K, NFE + 1, gen)
        got = ku.era_update(x, buf, tau, hist, lag_w, AM4, cx, ce)
        want = ku.era_update_plain(x, buf, tau, hist, lag_w, AM4, cx, ce)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        errs[name] = err
        log(f"era_update {name}: max_abs_err {err:.3e}")
        check(err <= ERA_TOL, f"era_update {name} error {err} > {ERA_TOL}")
        if timing is None:
            ms = time_ms(lambda: ku.era_update(x, buf, tau, hist, lag_w, AM4, cx, ce))
            plain_ms = time_ms(
                lambda: ku.era_update_plain(x, buf, tau, hist, lag_w, AM4, cx, ce)
            )
            nbytes = era_bytes(x, tau, hist)
            # predictor 2k, corrector 7, DDIM update 3 flops an element
            flops = float(rows * n * (2 * K + 10))
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
            bound_ms = max(t_bytes, t_ops) * 1e3
            timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by="bytes" if t_bytes >= t_ops else "operations",
                          library_ms=None, shape=f"B={rows} N={n} k={K}")
            log(f"era_update bound: {nbytes / (rows * n * 4):.2f} float32 "
                f"words an element, {bound_ms:.5f} ms")
    return max(errs.values()), timing


# ---------------------------------------------------------------------------
# phase 3: flash_attention
# ---------------------------------------------------------------------------


def phase_flash(kf):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    dev = "cuda"

    def inputs(b, s, h, kvh, hd):
        q = torch.randn(b, s, h, hd, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(b, s, kvh, hd, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(b, s, kvh, hd, generator=gen, device=dev).to(torch.bfloat16)
        pos = torch.arange(s, dtype=torch.int32, device=dev)
        return q, k, v, pos

    def run(name, b, s, h, kvh, hd, **kw):
        q, k, v, pos = inputs(b, s, h, kvh, hd)
        if kw.get("kv_mask") == "padded":
            lengths = torch.tensor([s, s // 2, 1, 0] + [s] * (b - 4), device=dev)
            kw["kv_mask"] = (pos[None, :] < lengths[:, None]).to(torch.int32)
        got = kf.flash_attention(q, k, v, pos, pos, **kw)
        want = kf.flash_attention_plain(q, k, v, pos, pos, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()), f"flash {name}: non-finite")
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        excess = float((diff - FLASH_RTOL * want.float().abs()).max())
        log(f"flash_attention {name}: max_abs_err {err:.3e}")
        check(excess <= FLASH_ATOL,
              f"flash {name} error {err} beyond {FLASH_ATOL} + {FLASH_RTOL}*|o|")
        if "kv_mask" in kw:
            # the row whose every key is masked must come out exactly zero
            check(bool((got[3] == 0).all()), f"flash {name}: masked row not zero")
        return err, (q, k, v, pos)

    b, s, h, kvh, hd = 8, 256, 12, 2, 128
    errs = []
    err, (q, k, v, pos) = run("qwen2 B=8 S=256 H=12 KV=2 hd=128 non-causal",
                              b, s, h, kvh, hd, causal=False)
    errs.append(err)
    errs.append(run("kv_mask padded rows + fully masked row", b, s, h, kvh, hd,
                    causal=False, kv_mask="padded")[0])
    errs.append(run("causal+window=48+protected=4", b, s, h, kvh, hd,
                    causal=True, window=48, protected=4)[0])
    errs.append(run("softcap=30", b, s, h, kvh, hd, causal=False,
                    softcap=30.0)[0])
    errs.append(run("S=200 (ragged tile)", 2, 200, h, kvh, hd, causal=False)[0])
    errs.append(run("hd=64 (llama3.2-1b heads)", 2, 256, 32, 8, 64,
                    causal=False)[0])
    errs.append(run("hd=32 (smoke heads)", 2, 96, 4, 2, 32, causal=True)[0])

    ms = time_ms(lambda: kf.flash_attention(q, k, v, pos, pos, causal=False))
    plain_ms = time_ms(
        lambda: kf.flash_attention_plain(q, k, v, pos, pos, causal=False), iters=5
    )
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(h // kvh, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(h // kvh, dim=2).transpose(1, 2).contiguous()
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    flops = 4.0 * b * h * s * s * hd
    nbytes = 2.0 * (2 * b * s * h * hd + 2 * b * s * kvh * hd)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    timing = dict(
        ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        shape=f"B={b} S={s} H={h} KV={kvh} hd={hd} bf16",
    )
    return max(errs), timing


# ---------------------------------------------------------------------------
# phase 4: the sampling slice
# ---------------------------------------------------------------------------


def phase_slice(ku, kf):
    from repro_torch.configs import get_config
    from repro_torch.core import linear_schedule
    from repro_torch.models import DiffusionLM
    from repro_torch.serving import BatchedSampler, SampleRequest, result_keys

    cfg = get_config("qwen2-1.5b")
    check(
        (cfg.num_layers, cfg.d_model, cfg.dtype) == (28, 1536, torch.bfloat16),
        f"unexpected config {cfg}",
    )
    t0 = time.perf_counter()
    dlm = DiffusionLM(cfg, seed=0)  # on the card
    # the reference zero-inits eps_head (eps = x_t); small random weights
    # make the backbone reach the output
    gen = torch.Generator(device="cuda").manual_seed(3)
    w = torch.randn(cfg.d_model, cfg.d_model, generator=gen, device="cuda")
    dlm.eps_head.w.copy_(w * (0.5 / cfg.d_model**0.5))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in dlm.parameters())
    log(f"model: {cfg.name} {cfg.num_layers} layers d={cfg.d_model} "
        f"{n_params / 1e9:.3f}B params, built in {time.perf_counter() - t0:.1f}s")

    sched = linear_schedule()
    eng = BatchedSampler(dlm, sched)
    reqs = [
        SampleRequest(batch=1, seq_len=256, nfe=NFE, solver="era", seed=11),
        SampleRequest(batch=3, seq_len=256, nfe=NFE, solver="era", seed=12),
        SampleRequest(batch=4, seq_len=128, nfe=NFE, solver="era", seed=13),
    ]
    # warm drain: first launches build the Triton kernel and cuBLAS plans
    eng.submit_with_future(reqs[0])
    eng.drain()

    futs = [eng.submit_with_future(r)[1] for r in reqs]
    ku.era_update.launches = 0
    kf.flash_attention.launches = 0
    t0 = time.perf_counter()
    eng.drain()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    launches = {
        "era_update": ku.era_update.launches,
        "flash_attention": kf.flash_attention.launches,
    }
    results = [f.result() for f in futs]
    fused = len({(r.seq_len, r.nfe) for r in reqs})
    log(f"drain: {len(reqs)} requests in {fused} fused batches, "
        f"{drain_s:.3f}s, launches {launches}")
    check(launches["era_update"] == fused * (NFE - K + 1),
          f"era_update launches {launches['era_update']} != "
          f"{fused * (NFE - K + 1)}")
    check(launches["flash_attention"] == fused * cfg.num_layers * NFE,
          f"flash_attention launches {launches['flash_attention']} != "
          f"{fused * cfg.num_layers * NFE}")
    for req, res in zip(reqs, results):
        check(tuple(res.x0.shape) == (req.batch, req.seq_len, cfg.d_model),
              f"x0 shape {tuple(res.x0.shape)}")
        check(bool(torch.isfinite(res.x0).all()), "x0 not finite")
        for key in (result_keys.DELTA_EPS_HISTORY,
                    result_keys.DELTA_EPS_HISTORY_PER_SAMPLE,
                    result_keys.ERS_SELECTION_HISTORY, *result_keys.INFO_KEYS):
            check(key in res.info, f"missing result key {key}")
        check(tuple(res.aux[result_keys.ERS_SELECTION_HISTORY].shape)
              == (NFE, req.batch, K), "selection history shape")
        log(f"request batch={req.batch} seq={req.seq_len}: x0 std "
            f"{float(res.x0.std()):.4f}, batch wall {res.batch_wall_s:.3f}s "
            f"({res.batch_wall_s / NFE * 1e3:.2f} ms/NFE), padded batch "
            f"{res.padded_batch}, delta_eps[-1] "
            f"{[round(float(d), 3) for d in res.aux['delta_eps_history_per_sample'][-1]]}")

    # the same requests again: a request's x0 depends only on its seed and
    # shape, so the repeat is bitwise equal; its wall time is the steady state
    futs2 = [eng.submit_with_future(r)[1] for r in reqs]
    t0 = time.perf_counter()
    eng.drain()
    repeat_s = time.perf_counter() - t0
    for res, fut in zip(results, futs2):
        check(torch.equal(res.x0, fut.result().x0), "repeat drain differs")
    log(f"repeat drain: {repeat_s:.3f}s, batch walls "
        f"{sorted({round(f.result().batch_wall_s, 3) for f in futs2})}s")

    # the batch-of-3 request alone: its rows must not depend on batch-mates.
    # Both runs pad to the same 8-row bucket, so every matrix product has the
    # same shape; we expect agreement to bf16 rounding of the latents.
    _, solo_fut = eng.submit_with_future(reqs[1])
    t0 = time.perf_counter()
    eng.drain()
    torch.cuda.synchronize()
    solo_wall_ms = (time.perf_counter() - t0) * 1e3
    solo = solo_fut.result()
    fused_res = results[1]
    diff = float((solo.x0 - fused_res.x0).abs().max())
    same_sel = bool(torch.equal(
        solo.aux["ers_selection_history"], fused_res.aux["ers_selection_history"]
    ))
    log(f"batch-of-3 fused vs solo: max_abs_diff {diff:.3e}, "
        f"ERS selections equal {same_sel}")
    check(same_sel, "ERS selections differ between fused and solo runs")
    check(diff <= 1e-2, f"fused vs solo x0 differ by {diff}")

    # the same solo drain once more, under the profiler, for the breakdown
    eng.submit_with_future(reqs[1])
    profile_drain(eng, solo_wall_ms)
    per_nfe_ms = drain_s / (fused * NFE) * 1e3
    return launches, drain_s, per_nfe_ms


def profile_drain(eng, plain_wall_ms: float) -> None:
    """Drain once under torch.profiler; print the device-time breakdown by
    kernel and the device's idle share, 1 - busy / wall.  The profiler adds
    host time of its own, so the wall is that of the same drain unprofiled
    (``plain_wall_ms``); the share over the trace's own device span (first
    device op to last) is printed beside it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.drain()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(spans), "profiler traced no device op")
    span_ms = (max(e for _, e in spans) - min(s for s, _ in spans)) / 1e3
    rows = []
    for evt in prof.key_averages():
        # device-side events only (kernels, memcpy, memset); the CPU-side
        # aten ops carry their kernels' time too and would count it twice
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    log(f"profile (one fused batch of 8x256, nfe={NFE}): device busy "
        f"{busy_ms:.1f} ms, {launches} device ops ({launches / NFE:.0f} per NFE)")
    log(f"  unprofiled wall {plain_wall_ms:.1f} ms: idle share "
        f"{1 - busy_ms / plain_wall_ms:.3f}; trace device span {span_ms:.1f} ms: "
        f"idle share {1 - busy_ms / span_ms:.3f}; profiled wall {wall_ms:.1f} ms")
    for ms, count, name in rows[:12]:
        log(f"  {ms:9.3f} ms  {count:6d}x  {name[:90]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import build
    from repro_torch.kernels import era_update as ku
    from repro_torch.kernels import flash_attention as kf

    t0 = time.perf_counter()
    lib = build.build(kf.SOURCE)
    log(f"built {lib.name} in {time.perf_counter() - t0:.1f}s")

    era_err, era_t = phase_era(ku)
    flash_err, flash_t = phase_flash(kf)
    launches, drain_s, per_nfe_ms = phase_slice(ku, kf)

    kernels = [
        dict(name="era_update", route="triton",
             source="src/repro_torch/kernels/era_update.py",
             replaces="src/repro/kernels/era_update.py:31",
             launches=launches["era_update"], max_abs_err=era_err,
             ms=era_t["ms"], kernel_ms=era_t["ms"], plain_ms=era_t["plain_ms"],
             bound_ms=era_t["bound_ms"], bound_by=era_t["bound_by"],
             library_ms=None, shape=era_t["shape"]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:34",
             launches=launches["flash_attention"], max_abs_err=flash_err,
             ms=flash_t["ms"], kernel_ms=flash_t["ms"],
             plain_ms=flash_t["plain_ms"], bound_ms=flash_t["bound_ms"],
             bound_by=flash_t["bound_by"], library_ms=flash_t["library_ms"],
             shape=flash_t["shape"]),
    ]
    log(f"slice: drain {drain_s:.3f}s, {per_nfe_ms:.2f} ms per NFE")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
