"""The port benchmark's shared yardstick: finding cells, configurations,
traffic kinds and metrics by name, the device checks, spans and the
profiler window, peaks and roofline arithmetic, seeded inputs and the
result line. Nothing here imports the port or JAX."""
