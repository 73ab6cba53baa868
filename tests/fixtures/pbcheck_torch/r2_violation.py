"""R2 fixture: host syncs on device tensors in a hot module."""
import numpy as np
import torch


def hot_step(logits, stream):
    """Five distinct device->host syncs in the decode hot path."""
    out = torch.argmax(logits, dim=-1)
    val = out.sum().item()            # sync: scalar readback
    host = np.asarray(out)            # sync: full-array transfer
    first = int(out[0])               # sync: one element
    torch.cuda.synchronize()          # sync: drains the card
    stream.synchronize()              # sync: drains the stream
    return val, host, first
