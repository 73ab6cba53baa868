"""Cold-start engine, load planner, adapter scheduling and crash
recovery (KV/state reconstruction)."""
