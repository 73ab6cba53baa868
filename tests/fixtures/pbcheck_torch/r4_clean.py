"""R4 fixture (clean): static shapes, buffers made before the capture,
and one capture cached by shape."""
import torch


class Stepper:
    """Captures a step that writes into buffers it was given."""

    def __init__(self, logits):
        self.logits = logits
        self.out = torch.empty(logits.shape[:-1], dtype=torch.long)
        self.graphs = {}

    def _step(self):
        nxt = torch.argmax(self.logits, dim=-1)
        self.out.copy_(torch.where(nxt > 0, nxt, 0))

    def capture(self, shapes):
        for shape in shapes:
            if shape not in self.graphs:
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    self._step()
                self.graphs[shape] = g
