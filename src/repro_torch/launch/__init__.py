"""Command-line entry points (``serve``, ``train``) and the mesh
descriptions they use."""
