"""Hand-written Hopper kernels of the port and their plain versions.

``ops`` holds the checked wrappers and their launch counts, ``ref`` the
plain PyTorch versions, ``build`` compiles ``csrc/*.cu`` at first use.
"""
