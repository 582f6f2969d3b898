from .optimizers import (OptState, adamw_init, clip_by_global_norm,  # noqa: F401
                         make_optimizer, make_schedule)
