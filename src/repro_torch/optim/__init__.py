from repro_torch.optim.optimizers import (AdamWConfig, OptConfig, SGDConfig,
                                          global_norm, opt_init, opt_update)

__all__ = ["AdamWConfig", "OptConfig", "SGDConfig", "global_norm",
           "opt_init", "opt_update"]
