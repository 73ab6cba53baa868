"""R1 fixture (suppressed): a deliberate read of the overwritten alias."""
import torch


def serve(model, static_in):
    """Reads the alias after the replay on purpose: it wants the latest
    output through the alias."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = model(static_in)
    latest = static_out
    graph.replay()
    return latest  # pbcheck: disable=R1 (wants the latest step's output through the alias)
