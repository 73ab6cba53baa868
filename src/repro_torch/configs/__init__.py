"""Architecture configs (own copy of the reference registry)."""
