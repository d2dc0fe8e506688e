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
    EngineConfig,
    build_engine,
    make_solver_config,
    warmup_kwargs,
)
from repro_torch.serving.metrics import MetricsRegistry
