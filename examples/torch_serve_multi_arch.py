"""Batched AR serving across the architecture families with the PyTorch
port: prefill and KV-cache decode on dense, MoE, MLA, SSM, hybrid, vlm and
audio backbones, an int8 KV cache, and a sliding-window (ring) decode far
past its window (the port's counterpart of
``examples/serve_multi_arch.py``).

    PYTHONPATH=src python examples/torch_serve_multi_arch.py          # on the card
    PYTHONPATH=src python examples/torch_serve_multi_arch.py --device cpu --gen 4

Every model is its smoke config with random seeded weights.  On the card
they compute in bf16, and deepseek-v2-lite's MLA head dims are widened to
the (192, 128) instance of the flash kernel (the smoke (48, 32) has none).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import frontend_features  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import Engine, ServeConfig  # noqa: E402

ARCHS = [
    "llama3.2-1b",           # dense GQA
    "mixtral-8x7b",          # MoE + SWA
    "deepseek-v2-lite-16b",  # MLA compressed cache
    "xlstm-350m",            # recurrent state
    "hymba-1.5b",            # hybrid attn+mamba, meta tokens
    "paligemma-3b",          # VLM (stub patches)
    "whisper-base",          # enc-dec audio (stub frames)
]


def example_config(name: str, device: torch.device, **kw):
    cfg = get_config(name, smoke=True).with_(**kw)
    if device.type != "cuda":
        return cfg
    cfg = cfg.with_(dtype=torch.bfloat16)
    if cfg.mla is not None:
        cfg = cfg.with_(mla=dataclasses.replace(
            cfg.mla, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128))
    return cfg


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--ring-gen", type=int, default=64)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    out = {}

    def serve(label, cfg, serve_cfg, batch, prompt_len, gen):
        model = build_model(cfg, device=dev, seed=0)
        eng = Engine(model, serve_cfg)
        prompts = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32))
        extras = {}
        key = {"vlm": "patches", "audio": "frames"}.get(cfg.family)
        if key:
            extras[key] = torch.from_numpy(frontend_features(
                rng, batch, cfg.frontend.num_positions, cfg.d_model))
        t0 = time.perf_counter()
        toks = eng.generate(prompts, gen, extras=extras)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        print(f"{label:24s} [{cfg.family:6s}] -> {tuple(toks.shape)} in "
              f"{dt:5.2f}s   head: {toks[0][:6].tolist()}")
        out[label] = toks

    for name in ARCHS:
        serve(name, example_config(name, dev), ServeConfig(max_len=256),
              args.batch, args.prompt_len, args.gen)
    serve("llama3.2-1b (int8 KV)", example_config("llama3.2-1b", dev, kv_quant="int8"),
          ServeConfig(max_len=256), args.batch, args.prompt_len, args.gen)
    # long context: a ring-buffer decode far past the window
    serve("llama3.2-1b (SWA-32)", example_config("llama3.2-1b", dev),
          ServeConfig(max_len=4096, window_override=32), 1, 100, args.ring_gen)
    print(f"(decoded {args.ring_gen} tokens through a 32-slot ring cache)")
    return out


if __name__ == "__main__":
    main()
