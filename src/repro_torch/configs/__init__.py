"""Model configurations of the LM side. Mirrors ``repro/configs``; the
dry-run's ``input_specs`` is not ported (it builds JAX shape structs for
``launch/*``)."""
from repro_torch.configs.base import (
    MambaConfig,
    ModelConfig,
    MoEConfig,
    SHAPES,
    ShapeSpec,
    reduced,
    runnable,
)
from repro_torch.configs.registry import ARCH_IDS, all_configs, get_config
