"""The training steps, the train state and the lr schedule (JAX
counterpart: train/)."""

from mastermetastyletransfer_tpu_torch.train.schedule import (  # noqa: F401
    make_lr_schedule,
)
from mastermetastyletransfer_tpu_torch.train.state import (  # noqa: F401
    TrainState, create_train_state, trainable_labels,
)
from mastermetastyletransfer_tpu_torch.train.step import (  # noqa: F401
    make_meta_train_step, make_train_step, prepare_batch_for_model,
)
