from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPE_NAMES,
    SHAPES,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    all_cells,
    applicable_shapes,
    get_config,
    get_shape,
    get_smoke_config,
)
