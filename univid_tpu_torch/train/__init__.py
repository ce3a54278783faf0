from .trainer import init_train_state, make_dit_train_step, make_optimizer
