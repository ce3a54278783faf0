from .config import (
    WanDiTConfig,
    WanVAEConfig,
    T5Config,
    GenerationConfig,
    WAN_CONFIGS,
    SIZE_CONFIGS,
    MAX_AREA_CONFIGS,
    SUPPORTED_SIZES,
)
from .dtypes import DTypePolicy, DEFAULT_POLICY
from .mesh import MeshSpec, make_mesh, AXIS_DP, AXIS_FSDP, AXIS_SP, AXIS_TP
