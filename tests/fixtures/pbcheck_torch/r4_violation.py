"""R4 fixture: hazards in captured code and a capture in a loop."""
import torch


class Stepper:
    """Captures its step, which syncs, allocates and indexes by a mask."""

    def __init__(self, logits):
        self.logits = logits
        self.graph = None

    def _step(self):
        nxt = torch.argmax(self.logits, dim=-1)
        self.count = nxt.sum().item()         # a host sync
        self.scratch = torch.zeros_like(nxt)  # kept past the capture
        keep = nxt > 0
        return nxt[keep]                      # a data-dependent shape

    def capture(self):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._step()

    def capture_each(self, batches):
        for b in batches:                     # a fresh graph per batch
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                torch.nonzero(b)
