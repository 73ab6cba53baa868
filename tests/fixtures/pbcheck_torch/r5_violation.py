"""R5 fixture: a chaos handler with a typo'd kind, missing kinds, and
an out-of-vocabulary recovery mode (self-contained schema + handler)."""

CHAOS_KINDS = ("crash", "partial_crash", "rejoin")


class Metrics:
    """Recovery-metrics sink with the asserted mode vocabulary."""

    def on_recovery(self, mode, t):
        """Record one recovery of the given mode at time ``t``."""
        assert mode in ("migrate", "reprefill", "repartition")


def apply_chaos(ev, metrics):
    """Dispatch one chaos event (deliberately broken for the test)."""
    if ev.kind == "crash":
        metrics.on_recovery("migrate", 0.0)
    elif ev.kind == "partial_cras":            # typo: unknown kind
        metrics.on_recovery("replay", 0.0)     # unknown recovery mode
    # "partial_crash" and "rejoin" are never handled
