"""R2 fixture (clean): host work on host values only."""
import numpy as np
import torch


def assemble(requests, device):
    """Builds a batch on the host, then sends it once."""
    lens = [len(r) for r in requests]
    batch = np.zeros((len(requests), max(lens)), np.int64)
    for i, r in enumerate(requests):
        batch[i, :len(r)] = np.asarray(r, np.int64)
    n = int(max(lens))
    return torch.from_numpy(batch).to(device, non_blocking=True), n
