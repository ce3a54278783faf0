"""Pyramid Reflection: the video-QA state machine, its frame scorer,
MMR selection and the judge / reflector clients."""
