from .kontext import (FluxConfig, TINY_FLUX, init_flux, flux_forward,
                      pack_latents, unpack_latents, image_token_ids,
                      build_rope_from_ids, timestep_embedding)
from .clip_text import (ClipTextConfig, TINY_CLIP_TEXT, init_clip_text,
                        clip_text_encode)

__all__ = [
    "FluxConfig", "TINY_FLUX", "init_flux", "flux_forward",
    "pack_latents", "unpack_latents", "image_token_ids",
    "build_rope_from_ids", "timestep_embedding",
    "ClipTextConfig", "TINY_CLIP_TEXT", "init_clip_text",
    "clip_text_encode",
]
