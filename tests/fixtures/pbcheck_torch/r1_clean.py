"""R1 fixture (clean): the output is copied before the next replay."""
import torch


def serve(model, static_in):
    """Copies each step's output before replaying again."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = model(static_in)
    graph.replay()
    first = static_out.clone()        # a value
    graph.replay()
    second = static_out               # the latest step's output, read now
    return first + second
