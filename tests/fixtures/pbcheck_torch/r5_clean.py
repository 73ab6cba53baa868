"""R5 fixture (clean): every kind handled, every mode in vocabulary."""

CHAOS_KINDS = ("crash", "partial_crash", "rejoin")


class Metrics:
    """Recovery-metrics sink with the asserted mode vocabulary."""

    def on_recovery(self, mode, t):
        """Record one recovery of the given mode at time ``t``."""
        assert mode in ("migrate", "reprefill", "repartition")


def apply_chaos(ev, metrics):
    """Dispatch one chaos event, exhaustively over CHAOS_KINDS."""
    if ev.kind == "crash":
        metrics.on_recovery("migrate", 0.0)
    elif ev.kind == "partial_crash":
        metrics.on_recovery("reprefill", 0.0)
    elif ev.kind == "rejoin":
        metrics.on_recovery("repartition", 0.0)
