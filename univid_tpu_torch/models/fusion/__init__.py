from .projector import (
    init_context_projector,
    context_projector_forward,
    projector_training_loss,
    adapt_sequence_length,
)
