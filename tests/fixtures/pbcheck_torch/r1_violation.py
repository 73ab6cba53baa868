"""R1 fixture: an alias of a graph's static output read after a replay."""
import torch


def serve(model, static_in):
    """Keeps the first step's output as an alias and reads it after the
    second replay, which overwrote it."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = model(static_in)
    graph.replay()
    first = static_out                # an alias, not a value
    graph.replay()
    return first + 1                  # reads the second step's output
