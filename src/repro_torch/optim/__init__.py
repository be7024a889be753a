from repro_torch.optim.optim import round_decay, sgd_init, sgd_update

__all__ = ["round_decay", "sgd_init", "sgd_update"]
