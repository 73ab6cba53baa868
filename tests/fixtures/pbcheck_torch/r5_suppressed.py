"""R5 fixture (suppressed): a partial handler that documents why."""

CHAOS_KINDS = ("crash", "partial_crash", "rejoin")


class Metrics:
    """Recovery-metrics sink with the asserted mode vocabulary."""

    def on_recovery(self, mode, t):
        """Record one recovery of the given mode at time ``t``."""
        assert mode in ("migrate", "reprefill", "repartition")


def apply_crash_only(ev, metrics):
    """Handles crashes only; the caller filters other kinds upstream."""
    # pbcheck: disable=R5 (upstream filter guarantees kind == "crash")
    if ev.kind == "crash":
        metrics.on_recovery("migrate", 0.0)
