"""Request serving: continuous batching and adapter epochs."""
