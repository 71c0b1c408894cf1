"""Ring trainers of the port (a ring of one shard so far)."""
