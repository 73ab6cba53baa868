"""Distribution: the pipeline prefill belt over a ('data', 'stage') grid of
devices (paper §4.3), the sharding rules and the activation policy (as
metadata on one card)."""
