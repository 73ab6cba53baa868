"""R2 fixture (suppressed): the step's one designed transfer."""
import torch


def hot_step(logits):
    """Reads the sampled tokens once, at the designed point."""
    nxt = torch.argmax(logits, dim=-1)
    # pbcheck: disable=R2 (designed sync: THE one host transfer per decode step)
    return nxt.cpu().numpy()
