from repro_torch.models import cnn

__all__ = ["cnn"]
