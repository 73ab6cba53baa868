"""R6 fixture (suppressed): an exempted public function."""


# pbcheck: disable=R6 (generated shim; name is the documentation)
def undocumented(x):
    return x + 1
