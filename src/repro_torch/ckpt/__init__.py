"""`repro_torch.ckpt` — npz checkpoints whose keys match the JAX
package's ``repro.ckpt`` for the same nested tree."""
from repro_torch.ckpt.checkpoint import load_pytree, restore_latest, \
    save_pytree

__all__ = ["load_pytree", "restore_latest", "save_pytree"]
