"""The port's mesh (``launch/mesh.py``, ``parallel/{sharding,ctx}.py`` and
the ``mesh=`` of the executor, the sampler, the factory and ``Engine``)
against the JAX reference on the CPU.

The sharding rules are spec logic with no devices: the port's specs are
held equal to the reference's for every architecture, with fsdp on and
off, on the reference's fake mesh shapes (``tests/test_sharding.py``); a
port tensor has no layer axis, so its spec is the reference's stacked
spec without the leading None.  The serving mesh runs on two ``cpu``
entries: on the CPU a row's result does not depend on the rows batched
with it (ROADMAP queue 3), so a drain or a generation split into two row
blocks is bitwise the unsplit one.
"""

import dataclasses
import functools

import jax
import pytest
import torch

from repro.configs import arch_names as jarch_names
from repro.configs import get_config as jget_config
from repro.core import default_config as jdefault_config
from repro.core import get_program as jget_program
from repro.models import build_model as jbuild_model
from repro.parallel import sharding as JS
from repro_torch.configs import arch_names, get_config
from repro_torch.core import (
    ERAConfig,
    default_config,
    get_program,
    linear_schedule,
    solver_names,
)
from repro_torch.launch.mesh import (
    HBM_BW,
    PEAK_FLOPS_BF16,
    Mesh,
    make_host_mesh,
    make_sampler_mesh,
    parse_layout,
)
from repro_torch.models import DiffusionLM, build_model
from repro_torch.parallel import ctx
from repro_torch.parallel import sharding as S
from repro_torch.serving import (
    BatchedSampler,
    EngineConfig,
    Engine,
    SampleRequest,
    ServeConfig,
    build_engine,
)
from test_torch_engine import _tokens

CPU2 = ["cpu", "cpu"]
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """The reference test's mesh: axis names and a shape, no devices."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = shape


def _flat(tree) -> dict:
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _norm(spec) -> tuple:
    """A spec as a tuple whose one-axis entries are bare names (the
    installed jax's ``PartitionSpec`` normalizes ``("data",)`` so)."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in tuple(spec))


def _spec(spec, ndim: int) -> tuple:
    spec = _norm(spec)
    return spec + (None,) * (ndim - len(spec))


@functools.lru_cache(maxsize=None)
def _reference_abstract(name: str):
    return jbuild_model(jget_config(name)).init_abstract()


@functools.lru_cache(maxsize=None)
def _port_shapes(name: str) -> dict:
    model = build_model(get_config(name), device="meta")
    return {n: p for n, p in model.named_parameters()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("name", arch_names())
def test_param_specs_equal_reference(name, fsdp, mesh):
    shape = MESHES[mesh]
    aparams = _reference_abstract(name)
    ref = _flat(JS.ShardingRules(jget_config(name), FakeMesh(shape), fsdp=fsdp)
                .param_pspec(aparams))
    leaves = _flat(aparams)
    port = S.ShardingRules(get_config(name), Mesh.abstract(shape), fsdp=fsdp)
    named = _port_shapes(name)
    specs = port.param_pspec(named)
    seen = set()
    for pname, t in named.items():
        path, stacked = S.reference_path(pname, port.cfg)
        want = tuple(ref[path])
        assert tuple(leaves[path].shape) == (
            (leaves[path].shape[0],) + tuple(t.shape) if stacked else tuple(t.shape)), pname
        if stacked:
            assert want[0] is None
            want = want[1:]
        assert _spec(specs[pname], t.ndim) == _spec(want, t.ndim), (pname, path)
        seen.add(path)
    assert seen == set(ref)   # every reference leaf has a port parameter


def test_reference_examples_hold_on_the_port():
    """``test_sharding.py``'s named cases, read on the port's names."""
    def specs(name, fsdp=False):
        rules = S.ShardingRules(get_config(name), Mesh.abstract(MESHES["single"]), fsdp)
        return rules.param_pspec(_port_shapes(name))

    llama = specs("llama3.2-1b")
    assert llama["backbone.layers.0.mlp.wi.w"] == (None, "model")
    assert llama["backbone.layers.0.mlp.wo.w"] == ("model", None)
    assert llama["embed"] == ("model", None)
    assert specs("deepseek-v2-lite-16b")["backbone.layers.0.moe.experts.wi"] == (
        "model", None, None)
    mixtral = specs("mixtral-8x7b")
    assert mixtral["backbone.layers.0.moe.experts.wi"] == (None, None, "model")
    assert mixtral["backbone.layers.0.moe.experts.wo"] == (None, "model", None)
    big = specs("deepseek-67b", fsdp=True)
    assert "data" not in str(big["embed"])
    assert "data" in str(big["backbone.layers.0.mlp.wi.w"])


def test_registries_agree():
    assert arch_names() == jarch_names()


@pytest.mark.parametrize("shape,batch,per_sample", [
    ({"data": 8}, 16, True), ({"data": 8}, 3, True), ({"data": 8}, None, False),
    ({"pod": 2, "data": 8, "model": 2}, 16, False), ({"model": 4}, 8, True)])
def test_sampler_pspecs_equal_reference(shape, batch, per_sample):
    want = JS.sampler_pspecs(FakeMesh(shape), batch=batch, per_sample=per_sample)
    got = S.sampler_pspecs(Mesh.abstract(shape), batch=batch, per_sample=per_sample)
    assert got._fields == want._fields
    for field in want._fields:
        assert _norm(getattr(got, field)) == _norm(getattr(want, field)), field


@pytest.mark.parametrize("name", solver_names())
def test_carry_pspecs_equal_reference(name):
    mesh = {"data": 8}
    for cfg_kw in ({}, {"per_sample": True}) if name == "era" else ({},):
        jcfg = jdefault_config(name, **cfg_kw)
        tcfg = default_config(name, **cfg_kw)
        jprog, tprog = jget_program(name), get_program(name)
        assert tprog.per_sample_state(tcfg) == jprog.per_sample_state(jcfg)
        for batch in (16, 3):
            want = jprog.carry_pspecs(jcfg, FakeMesh(mesh), batch=batch)
            got = tprog.carry_pspecs(tcfg, Mesh.abstract(mesh), batch=batch)
            assert [_norm(g) for g in got] == [_norm(w) for w in want]
            assert tuple(S.solver_carry_pspecs(Mesh.abstract(mesh), tprog, tcfg,
                                               batch=batch)) == tuple(got)


def test_round_to_dp_equals_reference():
    for shape in ({"data": 8}, {"pod": 2, "data": 4}, {"data": 1, "model": 4}):
        for n in (1, 5, 8, 9, 33):
            assert S.round_to_dp(n, Mesh.abstract(shape)) == JS.round_to_dp(
                n, FakeMesh(shape))
    assert S.round_to_dp(5, None) == 5


def test_batch_opt_and_cache_specs():
    rules = S.ShardingRules(get_config("llama3.2-1b"), Mesh.abstract({"data": 8, "model": 4}))
    assert rules.batch_pspec({"tokens": torch.empty(16, 4), "pos": torch.empty(())}) == {
        "tokens": (("data",), None), "pos": ()}
    assert rules.batch_pspec({"tokens": torch.empty(3, 4)})["tokens"] == (None, None)
    model = build_model(get_config("llama3.2-1b"), device="meta")
    cache = model.init_cache(16, 8192)
    spec = rules.cache_pspec(cache)["0_dense"]
    assert spec["k"] == (None, ("data",), "model", None, None)
    assert spec["pos"] == (None,)
    named = dict(model.named_parameters())
    opt = rules.opt_pspec({"m": named, "v": named, "step": torch.zeros(())})
    assert opt["step"] == () and opt["m"] == opt["v"] == rules.param_pspec(named)


def test_shard_bytes():
    mesh = Mesh.abstract({"data": 2, "model": 4})
    assert S.shard_bytes((8, 16), 2, (None, "model"), mesh) == 8 * 16 * 2 / 4
    assert S.shard_bytes((8, 16), 2, (("data",), "model"), mesh) == 8 * 16 * 2 / 8
    assert S.shard_bytes((), 4, (), mesh) == 4


def test_mesh_construction():
    mesh = make_host_mesh(devices=CPU2)
    assert mesh.shape == {"data": 2, "model": 1} and S.dp_size(mesh) == 2
    assert make_host_mesh(model_parallel=2, devices=CPU2).shape == {"data": 1, "model": 2}
    mesh = make_sampler_mesh(max_devices=1, devices=CPU2)
    assert mesh.shape == {"data": 1} and len(mesh.devices) == 1
    assert parse_layout("8x2").shape == {"data": 8, "model": 2}
    assert Mesh.abstract({"data": 4}).devices is None
    with pytest.raises(ValueError, match="DxM"):
        parse_layout("8")
    with pytest.raises(ValueError):
        Mesh(("data",), (2,), ["cpu"])
    assert (PEAK_FLOPS_BF16, HBM_BW) == (989e12, 3.35e12)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            make_sampler_mesh()
    else:
        assert S.dp_size(make_sampler_mesh()) == torch.cuda.device_count()


def test_activation_context_is_a_no_op():
    x = torch.randn(4, 3)
    assert ctx.constrain_batch(x) is x
    with ctx.activation_sharding(("data",), seq_parallel=True):
        assert ctx.constrain_batch(x) is x
        assert ctx.constrain_dims(x, ("dp", "tp")) is x


def test_param_replicator_rebuilds_after_a_change():
    """One copy a mesh device (the module itself on its own device), rebuilt
    when a parameter is changed in place or replaced, not otherwise."""
    model = build_model(get_config("llama3.2-1b", smoke=True), device="cpu")
    rep = S.ParamReplicator(Mesh(("data",), (2,), ["cpu", "meta"]))
    first = rep(model)
    assert first[0] is model and first[1].embed.device.type == "meta"
    assert rep(model) is first and rep.builds == 1
    with torch.no_grad():
        model.embed.add_(1.0)              # in place: its _version moves
    second = rep(model)
    assert rep.builds == 2 and second[1] is not first[1]
    model.backbone.final_norm.scale = torch.nn.Parameter(
        torch.ones_like(model.backbone.final_norm.scale), requires_grad=False)
    rep(model)
    assert rep.builds == 3
    rep(model)
    assert rep.builds == 3
    with pytest.raises(ValueError, match="abstract"):
        S.ParamReplicator(Mesh.abstract({"data": 2}))


@functools.lru_cache(maxsize=None)
def _dlm():
    dlm = DiffusionLM(get_config("qwen2-1.5b", smoke=True), device="cpu", seed=0)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        dlm.eps_head.w.copy_(torch.randn(dlm.eps_head.w.shape, generator=gen) * 0.05)
    return dlm


def test_buckets_round_to_dp():
    mesh = make_sampler_mesh(devices=CPU2)
    eng = BatchedSampler(_dlm(), linear_schedule(), batch_buckets=(1, 8, 64), mesh=mesh)
    assert eng.batch_buckets == (2, 8, 64) and eng.dp == 2 and eng.mesh is mesh
    assert eng.executor.bucket_batch(65) == 66
    built = build_engine(_dlm(), linear_schedule(), EngineConfig(batch_buckets=(1, 8)),
                         mesh=mesh)
    assert built.batch_buckets == (2, 8)


REQS = [SampleRequest(batch=3, seq_len=12, nfe=10, seed=5),
        SampleRequest(batch=2, seq_len=16, nfe=8, seed=6),
        SampleRequest(batch=1, seq_len=9, nfe=10, seed=7)]


def _drain(solver: str, mesh) -> list:
    eng = BatchedSampler(_dlm(), linear_schedule(), solver=solver,
                         batch_buckets=(8,), seq_buckets=(8, 16),
                         nfe_buckets=(10,), mesh=mesh)
    futs = [eng.submit_with_future(dataclasses.replace(r, solver=solver))[1]
            for r in REQS]
    eng.drain()
    return [f.result() for f in futs]


@pytest.mark.parametrize("solver", ["era", "ddim"])
def test_mesh_drain_is_bitwise_the_unsplit_drain(solver):
    """Six rows fused into one 8-row batch (seq bucket 16, NFE bucket 10)
    run as two 4-row blocks: every request's x0 and diagnostics bitwise the
    unsplit drain's, ERS selections equal."""
    whole = _drain(solver, None)
    split = _drain(solver, make_sampler_mesh(devices=CPU2))
    for w, s in zip(whole, split):
        assert s.padded_batch == w.padded_batch == 8
        assert torch.equal(s.x0, w.x0)
        assert set(s.aux) == set(w.aux)
        for key, value in w.aux.items():
            assert torch.equal(s.aux[key], value), key
    if solver == "era":
        assert "ers_selection_history" in split[0].aux


def test_non_fusable_chunk_runs_whole_on_the_first_device():
    """The paper config (shared delta_eps) couples its rows: no split."""
    mesh = make_sampler_mesh(devices=CPU2)
    kw = dict(solver_config=ERAConfig(per_sample=False), batch_buckets=None)
    whole = BatchedSampler(_dlm(), linear_schedule(), **kw)
    split = BatchedSampler(_dlm(), linear_schedule(), mesh=mesh, **kw)
    assert split.executor._blocks(("era", ERAConfig(per_sample=False, nfe=6), 3, 8,
                                   False, False)) == [
        (None, slice(0, 3), ("era", ERAConfig(per_sample=False, nfe=6), 3, 8, False, False))]
    req = SampleRequest(batch=3, seq_len=8, nfe=6, seed=1)
    a, b = (e.submit_with_future(req)[1] for e in (whole, split))
    whole.drain()
    split.drain()
    assert torch.equal(a.result().x0, b.result().x0)


@pytest.mark.parametrize("batch,greedy", [(4, True), (4, False), (3, True)],
                         ids=["split-greedy", "split-sampled", "whole"])
def test_engine_mesh_generates_the_unsplit_tokens(batch, greedy):
    cfg = get_config("llama3.2-1b", smoke=True)
    model = build_model(cfg, device="cpu")
    serve = ServeConfig(max_len=32, greedy=greedy, temperature=0.7)
    prompts = torch.from_numpy(_tokens(cfg.vocab_size, (batch, 6), 4))
    mesh = make_sampler_mesh(devices=CPU2)
    plain = Engine(model, serve).generate(
        prompts, 8, generator=torch.Generator().manual_seed(9))
    eng = Engine(model, serve, mesh=mesh)
    assert eng.dp == 2 and len(eng._blocks(batch)) == (2 if batch % 2 == 0 else 1)
    split = eng.generate(prompts, 8, generator=torch.Generator().manual_seed(9))
    assert torch.equal(plain, split)


def test_model_axis_raises_in_serving():
    mesh = make_host_mesh(model_parallel=2, devices=CPU2)
    with pytest.raises(ValueError, match="Tensor parallelism across cards"):
        BatchedSampler(_dlm(), linear_schedule(), mesh=mesh)
    with pytest.raises(ValueError, match="Tensor parallelism across cards"):
        Engine(build_model(get_config("llama3.2-1b", smoke=True), device="cpu"),
               mesh=mesh)


def test_mesh_first_device_must_be_the_models():
    """A batch that does not split runs whole on the model's device, so a
    mesh that does not start there raises."""
    mesh = Mesh(("data",), (2,), ["meta", "cpu"])
    with pytest.raises(ValueError, match="first device"):
        BatchedSampler(_dlm(), linear_schedule(), mesh=mesh)
    with pytest.raises(ValueError, match="first device"):
        Engine(build_model(get_config("llama3.2-1b", smoke=True), device="cpu"),
               mesh=mesh)


def test_one_device_mesh_is_the_path_without_a_mesh():
    """At dp = 1 a chunk is one block on the engine's own denoiser: no copy
    of the weights, no gather, and the drain bitwise the plain one."""
    mesh = make_sampler_mesh(devices=["cpu"])
    eng = BatchedSampler(_dlm(), linear_schedule(), batch_buckets=(8,), mesh=mesh)
    key = ("era", ERAConfig(nfe=6), 8, 8, False, False)
    assert eng.executor._blocks(key) == [(None, slice(0, 8), key)]
    plain = BatchedSampler(_dlm(), linear_schedule(), batch_buckets=(8,))
    req = SampleRequest(batch=3, seq_len=8, nfe=6, seed=2)
    a, b = (e.submit_with_future(req)[1] for e in (plain, eng))
    plain.drain()
    eng.drain()
    assert torch.equal(a.result().x0, b.result().x0)
    assert eng.executor._replicate.builds == 0
