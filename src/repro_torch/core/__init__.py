"""Cold-start engine, load planner and adapter scheduling."""
