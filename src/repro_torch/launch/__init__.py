"""Entry points of the port.  Only ``serve`` (prefill, decode, greedy
generation) is ported so far; mesh, sharding, training and the dry run
wait for the mesh slice (ROADMAP queue 1)."""
