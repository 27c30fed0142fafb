"""Training of the port: optimizer factory and the train step."""

from .optim import MILESTONES, build_optimizer, multistep_schedule  # noqa: F401
from .steps import (  # noqa: F401
    TrainState,
    create_state,
    dequantize_input,
    make_train_step,
)
