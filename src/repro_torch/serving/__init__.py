"""Request serving: continuous batching, adapter epochs and crash
migration (KV snapshots)."""
