"""Device meshes and multi-process bootstrap for the gallery's sharded tier
and the shard router's host-side merge."""
