"""Training of the port: the data pipeline, schedules, the optimizer, the
train step over the flat train state (on one device or sharded over a
mesh of processes) and the fault-tolerant trainer — the counterparts of
the JAX package's ``train`` modules."""

from repro_torch.train.data import SyntheticLM  # noqa: F401
from repro_torch.train.loop import (  # noqa: F401
    SimulatedPreemption,
    TorchTrainer,
    TrainerConfig,
)
from repro_torch.train.optim import (  # noqa: F401
    Adafactor,
    AdamW,
    make_optimizer,
)
from repro_torch.train.schedule import warmup_cosine  # noqa: F401
from repro_torch.train.step import (  # noqa: F401
    TrainStep,
    init_train_state,
    make_train_step,
    shard_state,
    state_shardings,
    train_state_specs,
)
