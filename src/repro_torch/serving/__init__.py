from repro_torch.serving import result_keys
from repro_torch.serving.diffusion_sampler import BatchedSampler, SamplerService
from repro_torch.serving.engine import (
    Engine,
    ServeConfig,
    cache_slots,
    resolve_window,
)
from repro_torch.serving.executor import (
    DEFAULT_MAX_BATCH,
    DEFAULT_MAX_NFE,
    DEFAULT_MAX_SEQ_LEN,
    SEED_MAX,
    SEED_MIN,
    FusedExecutor,
    SampleRequest,
    SampleResult,
)
from repro_torch.serving.factory import (
    WARMUP_MODES,
    EngineConfig,
    build_engine,
    make_solver_config,
    warmup_kwargs,
)
from repro_torch.serving.frontdoor import (
    SCHEMA_VERSION,
    FrontDoor,
    FrontDoorClient,
    SchemaError,
    decode_request,
    decode_result,
    encode_request,
    encode_result,
    serve_frontdoor,
)
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.scheduler import (
    AsyncBatchedSampler,
    DeadlineExceededError,
    QueueFullError,
    SchedulerPolicy,
    open_loop,
)

__all__ = [
    "DEFAULT_MAX_BATCH",
    "DEFAULT_MAX_NFE",
    "DEFAULT_MAX_SEQ_LEN",
    "SCHEMA_VERSION",
    "SEED_MAX",
    "SEED_MIN",
    "AsyncBatchedSampler",
    "BatchedSampler",
    "DeadlineExceededError",
    "Engine",
    "EngineConfig",
    "FrontDoor",
    "FrontDoorClient",
    "FusedExecutor",
    "MetricsRegistry",
    "QueueFullError",
    "SampleRequest",
    "SampleResult",
    "SamplerService",
    "SchedulerPolicy",
    "SchemaError",
    "ServeConfig",
    "WARMUP_MODES",
    "build_engine",
    "cache_slots",
    "decode_request",
    "decode_result",
    "encode_request",
    "encode_result",
    "make_solver_config",
    "open_loop",
    "resolve_window",
    "result_keys",
    "serve_frontdoor",
    "warmup_kwargs",
]
