from repro_torch.train.state import (  # noqa: F401
    TrainState, init_train_state, train_state_from_reference)
from repro_torch.train.step import make_train_step  # noqa: F401
