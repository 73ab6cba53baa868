"""Distribution: the pipeline prefill belt over a ('data', 'stage') grid of
devices (paper §4.3)."""
