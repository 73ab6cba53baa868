"""Adapter switches in the window (``ServingEngine.n_adapter_switches``):
each copies the adapter's merged weights into the batcher's own storage
after the batch has drained (the epoch barrier)."""


def read(ctx):
    return ctx.window.switches
