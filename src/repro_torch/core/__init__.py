"""Movement substrate and the two-tier KV store."""
