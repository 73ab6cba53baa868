"""R6 fixture (clean): everything public carries a docstring."""


def documented(x):
    """Add one."""
    return x + 1
