"""Tools that drive a node: the load generator's payload codec and its
latency statistics."""
