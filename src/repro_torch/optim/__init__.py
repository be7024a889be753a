from repro_torch.optim.optim import adamw_init, adamw_update, \
    cosine_decay, round_decay, sgd_init, sgd_update

__all__ = ["adamw_init", "adamw_update", "cosine_decay", "round_decay",
           "sgd_init", "sgd_update"]
