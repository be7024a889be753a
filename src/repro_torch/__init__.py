"""PyTorch/CUDA port of the real-time federated evolutionary NAS system.

Mirrors the JAX package ``repro`` module for module (``configs``,
``core``, ``data``, ``engine``, ``models``, ``optim``, ``kernels``) and
imports nothing of it.  ``convert`` carries CNN and LM weights between
the two packages' layouts; ``examples`` holds the example drivers
(``python -m repro_torch.examples.quickstart``).
"""
