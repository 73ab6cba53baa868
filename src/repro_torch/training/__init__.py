"""Training: AdamW, the train step, the data streams and checkpoints (the
port of ``repro/training``)."""
