from .qwen2_mot import (
    Qwen2MoTConfig,
    init_qwen2_mot,
    init_kv_cache,
    qwen2_mot_forward,
    lm_head_logits,
)
