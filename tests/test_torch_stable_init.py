"""``stable_init``: the reference's random weights, the same in every
process.

The reference's ``init_params``, ``init_lora`` and ``randomize_lora`` fold
``hash(kind)`` (or ``hash((kind, target))``) into their keys, and a str
hash changes with each process's hash seed: every process draws other
weights, and a few draws put a greedy pick or a router's k-th choice
within the two packages' sum-order distance of a tie.  Under
``stable_init`` those hashes are crc32s, so every process draws the same
weights.  The parity tests that compare exact streams or routing draw
their reference weights under it.
"""
import contextlib
import os
import subprocess
import sys
import zlib
from pathlib import Path
from unittest import mock

from repro.lora import adapters as jlora
from repro.models import transformer as JT

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def stable_init():
    """Within the block the reference draws its weights under crc32
    hashes of the kinds (see the module docstring)."""
    def stable(x):
        return zlib.crc32(repr(x).encode())
    with mock.patch.object(JT, "hash", stable, create=True), \
            mock.patch.object(jlora, "hash", stable, create=True):
        yield


_DRAW = """
import sys
import jax
import numpy as np
sys.path.insert(0, "tests")
from test_torch_stable_init import stable_init
from repro.configs.base import get_arch
from repro.lora import adapters as jlora
from repro.models import transformer as JT
cfg = get_arch("qwen2-moe-a2.7b").reduced()
with stable_init():
    p = JT.init_params(cfg, jax.random.PRNGKey(3))
    a = jlora.randomize_lora(jax.random.PRNGKey(5),
                             jlora.init_lora(jax.random.PRNGKey(4), cfg, 4))
leaves = jax.tree.leaves(p) + jax.tree.leaves(a.blocks)
print(sum(float(np.abs(np.asarray(x, np.float64)).sum()) * (i + 1)
          for i, x in enumerate(leaves)))
"""


def test_stable_init_draws_the_same_weights_under_any_hash_seed():
    """Two processes with different ``PYTHONHASHSEED``s draw equal
    reference weights (params and a randomized adapter) under
    ``stable_init``."""
    procs = []
    for seed in ("1", "2"):                 # both at once
        env = dict(os.environ, PYTHONHASHSEED=seed,
                   PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _DRAW], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    sums = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-2000:]
        sums.append(out.strip().splitlines()[-1])
    assert sums[0] == sums[1], sums
