"""Model configurations of the LM side. Mirrors ``repro/configs``;
``input_specs`` gives meta tensors where the reference gives
``jax.ShapeDtypeStruct``."""
from repro_torch.configs.base import (
    MambaConfig,
    ModelConfig,
    MoEConfig,
    SHAPES,
    ShapeSpec,
    input_specs,
    reduced,
    runnable,
)
from repro_torch.configs.registry import ARCH_IDS, all_configs, get_config
