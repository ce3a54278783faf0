from .ulysses import ulysses_attention
from .sharding import (
    dit_param_sharding_rules,
    apply_sharding_rules,
    shard_params,
)
