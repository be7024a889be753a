"""Entry points and distribution of the port: ``serve`` (prefill,
decode, greedy generation), ``train`` (the LM training step and its
driver), ``prefill_trace`` and ``ssd_rounding``; ``mesh`` (one-process
device meshes and their collectives), ``policy`` (the mesh the models
run under) and ``sharding`` (the parameter, batch and cache specs).  The
dry run (``specs``, ``roofline``, ``dryrun``) waits for the next slice
(ROADMAP queue 1)."""
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]
