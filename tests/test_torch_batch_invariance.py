"""The reference's determinism contract in the port (``docs/serving.md``):
a request's ``x0`` is bitwise the same in every batch bucket.

On the card it rests on the row-invariant GEMM (``kernels/gemm.py``) and
the row reductions (``kernels/rownorm.py``), whose launch depends on the
weight's shape or the row's width alone; ``chip_smoke.py``'s
``phase_batch_invariance`` holds them there.  Here, on the CPU:

* ``gemm_config`` takes no M, and has a configuration for every ``Linear``
  (K, N) of every full-width registry config (``linear_shapes``, config
  arithmetic, checked against the modules of the model built on ``meta``,
  which allocates nothing);
* the plain versions against the reference's ``x @ w + b``, ``rmsnorm``,
  ``layernorm`` and ``_seq_sq_sums`` (numpy inputs from a seed);
* ``row_sq_sums`` bitwise padding- and batch-invariant, ``gemm_plain``
  row-invariant (the lone row too);
* the smoke qwen2 and llama engines bitwise equal at batch buckets 1, 8
  and 64, and within tolerance of the reference's ``BatchedSampler``;
* a call that asks for a CUDA tensor raises instead of falling back.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ERAConfig as JERAConfig
from repro.core import era as jera
from repro.core import linear_schedule as jlinear_schedule
from repro.models import layers as jlayers
from repro.serving import BatchedSampler as JBatchedSampler
from repro.serving import SampleRequest as JSampleRequest
from repro_torch.configs import get_config
from repro_torch.configs.registry import arch_names
from repro_torch.core import linear_schedule
from repro_torch.kernels import gemm as kg
from repro_torch.kernels import rownorm as kr
from repro_torch.models import DiffusionLM, build_model
from repro_torch.models import layers as L
from repro_torch.serving import BatchedSampler, SampleRequest
from repro_torch.serving import result_keys as K
from test_torch_models import build_pair
from test_torch_serving import reference_noise

ARCHS = arch_names()
#: float32 products and norms against the reference (summation order)
F32_RTOL, F32_ATOL = 1e-5, 1e-5
#: bf16 products: the two frameworks may round a sum one bf16 step apart
BF16_ATOL = 2 ** -6
#: the smoke engine's x0 against the reference's (the parity tests' bar)
X0_ATOL = 2e-3


# ---------------------------------------------------------------------------
# gemm_config: the weight's shape alone
# ---------------------------------------------------------------------------

def test_gemm_config_takes_no_m():
    assert list(inspect.signature(kg.gemm_config).parameters) == [
        "k", "n", "dtype"]


def _module_shapes(cfg) -> set:
    """(d_in, d_out, dtype) of every Linear of the denoiser and the AR model
    of ``cfg``, built on ``meta``."""
    out = set()
    for model in (DiffusionLM(cfg, device="meta"), build_model(cfg, device="meta")):
        for mod in model.modules():
            if isinstance(mod, L.Linear):
                out.add((mod.w.shape[0], mod.w.shape[1], mod.w.dtype))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_linear_shapes_are_the_modules(arch):
    """``linear_shapes``'s arithmetic finds every Linear of the full-width
    models (serving stores each weight in its compute dtype)."""
    cfg = get_config(arch)
    assert kg.linear_shapes(cfg) == _module_shapes(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_gemm_config_covers_every_linear(arch):
    for k, n, dt in sorted(kg.linear_shapes(get_config(arch)), key=str):
        c = kg.gemm_config(k, n, dt)
        if dt == torch.float32:
            assert c.loader == "simt"
            assert (c.bm, c.bn, c.split) == kg.F32_TILE
            assert (c.split - 1) * c.k_per_split < k <= c.split * c.k_per_split
            continue
        assert (c.bm, c.bk) == (kg.BM, kg.BK)
        assert (c.bn, c.stages) in kg.BF16_INSTANCES
        k_tiles = -(-k // kg.BK)
        # every split has K tiles, and together they cover K once
        assert 1 <= c.split <= kg.MAX_SPLIT
        assert (c.split - 1) * c.k_per_split < k_tiles <= c.split * c.k_per_split
        # TMA needs 16-byte row pitches; the guarded loads take the rest
        assert (c.loader == "tma") == (k % 8 == 0 and n % 8 == 0)


def test_gemm_config_splits_only_narrow_weights():
    """qwen2's wk / wv (N = 256: two column tiles) split K in three; its
    wide weights do not split; another dtype has no instance."""
    assert kg.gemm_config(1536, 256, torch.bfloat16).split == 3
    for k, n in ((1536, 1536), (1536, 8960), (8960, 1536), (2048, 8192)):
        assert kg.gemm_config(k, n, torch.bfloat16).split == 1
    with pytest.raises(TypeError, match="no instance"):
        kg.gemm_config(64, 64, torch.float16)


# ---------------------------------------------------------------------------
# the plain versions against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,bias", [(1, 64, 96, True), (37, 128, 40, False),
                                        (256, 100, 132, True)])
def test_gemm_plain_matches_reference(m, k, n, bias):
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k), np.float32)
    w = rng.standard_normal((k, n), np.float32) * k ** -0.5
    b = rng.standard_normal((n,), np.float32) if bias else None
    p = {"w": jnp.asarray(w)} | ({"b": jnp.asarray(b)} if bias else {})
    ref = np.asarray(jlayers.linear(p, jnp.asarray(x)))
    tb = None if b is None else torch.from_numpy(b)
    got = kg.gemm(torch.from_numpy(x), torch.from_numpy(w), tb)
    np.testing.assert_allclose(got.numpy(), ref, rtol=F32_RTOL, atol=F32_ATOL)
    # bf16: the product rounded, then the bias add rounded again
    refb = np.asarray(jlayers.linear(
        jax_tree_bf16(p), jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    gotb = kg.gemm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                   None if tb is None else tb.bfloat16()).float()
    np.testing.assert_allclose(gotb.numpy(), refb, rtol=2 ** -7, atol=BF16_ATOL)


def jax_tree_bf16(p: dict) -> dict:
    return {name: v.astype(jnp.bfloat16) for name, v in p.items()}


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_norms_match_reference(dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 96), np.float32) * 2.0 + 0.5
    scale = rng.standard_normal((96,), np.float32)
    bias = rng.standard_normal((96,), np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x)
    tx = tx.bfloat16() if dtype == "bfloat16" else tx
    tol = dict(rtol=2 ** -7, atol=2 ** -7) if dtype == "bfloat16" else dict(
        rtol=F32_RTOL, atol=F32_ATOL)
    ref = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jx)
    got = kr.rmsnorm(tx, torch.from_numpy(scale))
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)
    ref = jlayers.layernorm({"scale": jnp.asarray(scale),
                             "bias": jnp.asarray(bias)}, jx)
    got = kr.layernorm(tx, torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)
    # the layers' functions are the wrappers
    assert torch.equal(L.rmsnorm(tx, torch.from_numpy(scale)),
                       kr.rmsnorm(tx, torch.from_numpy(scale)))


@pytest.mark.parametrize("shape,masked", [((4, 12, 6, 5), True),
                                          ((4, 12, 30), False), ((4, 50), False)])
def test_row_sq_sums_matches_reference(shape, masked):
    rng = np.random.default_rng(11)
    d = rng.standard_normal(shape, np.float32)
    valid = None
    if masked:
        valid = np.arange(shape[1])[None, :] < np.array([12, 7, 1, 9])[:, None]
    ref = np.asarray(jera._seq_sq_sums(
        jnp.asarray(d), None if valid is None else jnp.asarray(valid)))
    got = kr.row_sq_sums(torch.from_numpy(d),
                         None if valid is None else torch.from_numpy(valid))
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), ref, rtol=F32_RTOL, atol=F32_ATOL)


# ---------------------------------------------------------------------------
# invariance of the plain versions (the CPU route)
# ---------------------------------------------------------------------------

def test_row_sq_sums_padding_and_batch_invariant():
    rng = np.random.default_rng(5)
    d = torch.from_numpy(rng.standard_normal((6, 200, 48), np.float32))
    exact = kr.row_sq_sums(d, None)
    # padded to 256 with junk in the pad positions, masked out
    pad = torch.cat([d, torch.from_numpy(
        rng.standard_normal((6, 56, 48), np.float32))], dim=1)
    valid = (torch.arange(256) < 200)[None].expand(6, 256)
    assert torch.equal(kr.row_sq_sums(pad, valid), exact)
    for m in (1, 2, 5):
        assert torch.equal(kr.row_sq_sums(d[:m], None), exact[:m])


@pytest.mark.parametrize("k,n", [(128, 128), (256, 96), (128, 512)])
def test_gemm_plain_row_invariant(k, n):
    rng = np.random.default_rng(k * n)
    x = torch.from_numpy(rng.standard_normal((300, k), np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n), np.float32))
    b = torch.from_numpy(rng.standard_normal((n,), np.float32))
    full = kg.gemm(x, w, b)
    for m in (1, 2, 7, 64, 255):
        assert torch.equal(kg.gemm(x[:m], w, b), full[:m]), m


# ---------------------------------------------------------------------------
# the engines: bitwise across batch buckets, and against the reference
# ---------------------------------------------------------------------------

SEEDS = tuple(range(8))
SEQ, NFE = 8, 6


def _drain(tdlm, bucket: int, reqs):
    eng = BatchedSampler(tdlm, linear_schedule(), batch_buckets=(bucket,),
                         noise_fn=reference_noise(tdlm.config.d_model))
    futs = [eng.submit_with_future(r)[1] for r in reqs]
    eng.drain()
    return [f.result() for f in futs]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llama3.2-1b"])
def test_x0_bitwise_across_batch_buckets(arch):
    jdlm, params, tdlm = build_pair(arch, "naive", "auto", seed=3,
                                    head_scale=0.05)
    reqs = [SampleRequest(batch=1, seq_len=SEQ, nfe=NFE, seed=s) for s in SEEDS]
    solo = [_drain(tdlm, 1, [r])[0] for r in reqs]
    fused8 = _drain(tdlm, 8, reqs)
    # 64 rows: the eight among other seeds
    others = [SampleRequest(batch=4, seq_len=SEQ, nfe=NFE, seed=100 + i)
              for i in range(7)]
    fused64 = _drain(tdlm, 64, others[:4] + reqs + others[4:])[4:4 + len(reqs)]
    assert all(r.padded_batch == 8 for r in fused8)
    assert all(r.padded_batch == 64 for r in fused64)
    for one, eight, sixty_four in zip(solo, fused8, fused64):
        assert one.padded_batch == 1
        for other in (eight, sixty_four):
            assert torch.equal(one.x0, other.x0)
            assert torch.equal(one.aux[K.ERS_SELECTION_HISTORY],
                               other.aux[K.ERS_SELECTION_HISTORY])
    # and the reference's sampler (unfused ERA update) agrees within tolerance
    jeng = JBatchedSampler(
        jdlm, jlinear_schedule(),
        solver_config=JERAConfig(per_sample=True, use_fused_update=False))
    jf = [jeng.submit_with_future(JSampleRequest(batch=1, seq_len=SEQ, nfe=NFE,
                                                 seed=s))[1] for s in SEEDS]
    jeng.drain(params)
    for one, j in zip(solo, jf):
        np.testing.assert_allclose(one.x0.numpy(), np.asarray(j.result().x0),
                                   atol=X0_ATOL)


# ---------------------------------------------------------------------------
# no fallback: a CUDA tensor launches the kernel or raises
# ---------------------------------------------------------------------------

class _OnCuda(torch.Tensor):
    """A CPU tensor that says it lies on the card: the wrappers must take
    their kernel path for it, which raises here (no nvcc, no triton, no
    card) instead of computing the plain version."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(_OnCuda)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_call_raises_instead_of_falling_back(dtype):
    x, w = torch.ones(4, 64, dtype=dtype), torch.ones(64, 32, dtype=dtype)
    launches = kg.gemm.launches
    with pytest.raises((RuntimeError, AssertionError, ImportError)):
        kg.gemm(_cuda(x), _cuda(w))
    scale = torch.ones(64)
    with pytest.raises((RuntimeError, AssertionError, ImportError)):
        kr.rmsnorm(_cuda(x), _cuda(scale))
    with pytest.raises((RuntimeError, AssertionError, ImportError)):
        kr.row_sq_sums(_cuda(x.reshape(2, 2, 64)), None)
    assert kg.gemm.launches == launches
    # and a CUDA call in a dtype without an instance raises before any launch
    with pytest.raises(TypeError, match="no instance"):
        kg.gemm(_cuda(x.half()), _cuda(w.half()))


def test_norm_under_autograd_keeps_the_kernel_value_and_plain_gradient():
    """Under autograd a norm on the card returns its kernel's output (the
    serving forward) and takes the plain version's gradient: the value is
    the second input, the gradient reaches the first unchanged."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 16), np.float32)).requires_grad_()
    scale = torch.from_numpy(rng.standard_normal((16,), np.float32)).requires_grad_()
    plain = kr.rmsnorm_plain(x, scale)
    kernel = plain.detach() + 2 ** -10   # another rounding of the same norm
    out = kr._KernelValue.apply(plain, kernel)
    assert torch.equal(out, kernel)
    out.square().sum().backward()
    gx, gs = torch.autograd.grad(
        kr.rmsnorm_plain(x, scale), (x, scale), grad_outputs=2 * kernel)
    assert torch.equal(x.grad, gx) and torch.equal(scale.grad, gs)
