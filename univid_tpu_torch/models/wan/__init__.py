from .dit import (wan_dit_forward, wan_dit_forward_sp, patchify_latent,
                  unpatchify_tokens)
