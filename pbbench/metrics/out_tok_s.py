"""Output tokens that reached the host inside the window, over the
window's seconds."""
from pbb import stats


def read(ctx):
    return stats.tokens_in_window(list(ctx.window.stamps.values())) \
        / ctx.seconds
