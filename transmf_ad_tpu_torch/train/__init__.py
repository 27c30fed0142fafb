"""Training of the port: optimizer factory, the train and eval steps, the
metrics, the event engine, checkpoints, the Trainer and the k-fold
driver."""

from . import checkpoint  # noqa: F401
from .checkpoint import BestCheckpointer, find_best  # noqa: F401
from .engine import Engine, Events  # noqa: F401

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
from .trainer import Trainer, TrainerConfig, resolve_dtype  # noqa: F401
from .kfold import (  # noqa: F401
    METRIC_NAMES,
    dataset_weights,
    kfold_split,
    run_kfold,
    task_seed,
    train_val_split,
    transfer_dtype,
)
