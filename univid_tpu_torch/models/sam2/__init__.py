"""SAM2 video segmenter (counterpart of univid_tpu/models/sam2): Hiera
encoder, promptable mask decoder, streaming memory, and the video
predictor + animate-preprocess mask_fn adapter."""

from .hiera import HieraConfig, NeckConfig
from .memory import MemoryConfig
from .predictor import (KEY_POINT_INDICES, Sam2Config, Sam2VideoPredictor,
                        build_sam2_mask_fn, init_sam2, tiny_sam2_config)
from .sam_heads import SamHeadConfig
