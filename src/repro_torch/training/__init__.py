from repro_torch.training.step import (  # noqa: F401
    make_train_step,
    init_train_state,
    abstract_params,
)
from repro_torch.models.transformer import (  # noqa: F401
    init_params,
    forward_loss,
)
