from repro_torch.optim.optimizers import (AdamWConfig, OptConfig, SGDConfig,
                                          global_norm, opt_init, opt_update)
from repro_torch.optim.schedule import constant, cosine_warmup, step_decay

__all__ = ["AdamWConfig", "OptConfig", "SGDConfig", "constant",
           "cosine_warmup", "global_norm", "opt_init", "opt_update",
           "step_decay"]
