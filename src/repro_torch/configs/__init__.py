from repro_torch.configs.base import (
    FrontendStub,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)
from repro_torch.configs.registry import (
    ALIASES,
    INPUT_SHAPES,
    InputShape,
    arch_names,
    get_config,
    long_context_policy,
)
