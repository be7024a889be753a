from repro_torch.models import attention, cnn, layers, moe, ssm, transformer

__all__ = ["attention", "cnn", "layers", "moe", "ssm", "transformer"]
