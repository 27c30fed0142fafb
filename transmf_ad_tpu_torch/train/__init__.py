"""Training of the port: optimizer factory, the train and eval steps, and
the metrics."""

from .metrics import (  # noqa: F401
    MetricState,
    confusion_metrics,
    roc_auc,
    streaming_auc_init,
    streaming_auc_result,
    streaming_auc_update,
)
from .optim import MILESTONES, build_optimizer, multistep_schedule  # noqa: F401
from .steps import (  # noqa: F401
    TrainState,
    create_state,
    dequantize_input,
    make_eval_step,
    make_train_step,
)
