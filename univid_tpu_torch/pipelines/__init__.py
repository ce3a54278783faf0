from .ti2v import WanTI2VPipeline
