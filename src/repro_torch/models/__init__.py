from repro_torch.models import attention, cnn, layers, ssm, transformer

__all__ = ["attention", "cnn", "layers", "ssm", "transformer"]
