"""Pyramid Reflection: the video-QA state machine, its frame scorer,
MMR selection and the judge / reflector clients."""

from .scorer import Siglip2Scorer, SiglipTextConfig
from .mmr import mmr_select
from .clients import make_reflection_clients, QwenJudge, DeepSeekReflector
from .reflexion import reflexion_answer_one
