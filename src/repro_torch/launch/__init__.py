"""Entry points and distribution of the port: ``serve`` (prefill,
decode, greedy generation), ``train`` (the LM training step and its
driver), ``prefill_trace`` and ``ssd_rounding``; ``mesh`` (one-process
device meshes and their collectives), ``policy`` (the mesh the models
run under) and ``sharding`` (the parameter, batch and cache specs); the
dry run: ``specs`` (meta-tensor inputs), ``roofline`` (the H100's
constants, the step counter, the collectives of the specs) and
``dryrun`` (every arch x shape counted on the meta device)."""
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_production_mesh"]
