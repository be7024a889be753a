"""Hand-written Hopper kernels of the port and their plain versions.

``ops`` holds the checked wrappers and their launch counts, ``ref`` the
plain PyTorch versions, ``build`` compiles ``csrc/*.cu`` at first use,
and ``fill_aggregate``, ``quantize``, ``flash_attention``, ``ssd_scan``
and ``expert_gemm`` bind the compiled libraries.
"""
