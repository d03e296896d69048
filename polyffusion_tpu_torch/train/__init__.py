"""Train state, steps and loop."""

from .loop import MetricsLogger, Trainer  # noqa: F401
from .state import TrainState, create_state, make_optimizer, param_count  # noqa: F401
from .step import make_eval_step, make_train_step, step_generator  # noqa: F401
