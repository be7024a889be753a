"""Entry points of the port: ``serve`` (prefill, decode, greedy
generation), ``train`` (the LM training step and its driver),
``prefill_trace`` and ``ssd_rounding``.  Mesh, sharding and the dry run
wait for the mesh slice (ROADMAP queue 1)."""
