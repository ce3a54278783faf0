from .rope import build_rope_3d, apply_rope, rope_angles_1d, rope_dim_split
from .embeddings import sinusoidal_embedding_1d
from .samplers import (
    flow_sigmas,
    precompute_unipc,
    unipc_init_state,
    unipc_step,
    precompute_dpm_solver,
    dpm_init_state,
    dpm_step,
    euler_flow_step,
    add_flow_noise,
)
from .cfg import classifier_free_guidance, cfg_renorm
from .tma import tma_schedule_weights, apply_text_weight
