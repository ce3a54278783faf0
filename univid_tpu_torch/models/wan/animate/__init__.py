from .model import (WanAnimate, WanAnimateConfig, init_wan_animate,
                    wan_animate_forward)
from .motion_encoder import MotionEncoder, get_motion, init_motion_encoder
from .face_blocks import (face_block_forward, face_encoder_forward,
                          init_face_block, init_face_encoder)
from .clip_vit import (ClipVision, ClipVisionConfig, clip_preprocess,
                       clip_visual_forward, init_clip_vision)
from .clip_text import (ClipTextXlmRoberta, ClipTextXlmRobertaConfig,
                        clip_text_forward, convert_clip_text_xlm_roberta,
                        init_clip_text)
