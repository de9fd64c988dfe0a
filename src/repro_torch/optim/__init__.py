from repro_torch.optim.adamw import (  # noqa: F401
    init_opt_state,
    apply_updates,
    lr_schedule,
    global_norm,
)
