"""R6 fixture: a public function with no docstring."""


def undocumented(x):
    return x + 1
