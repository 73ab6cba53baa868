"""R4 fixture (suppressed): a deliberate allocation in captured code."""
import torch


class Stepper:
    """Keeps a buffer made inside the capture on purpose."""

    def __init__(self, logits):
        self.logits = logits

    def _step(self):
        # pbcheck: disable=R4 (the graph's pool owns this buffer for the graph's life; read only between replays)
        self.out = torch.argmax(self.logits, dim=-1).clone()

    def capture(self):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._step()
