"""Checkpoints: layer-addressable, atomic, async-capable (the port of
``repro/training/checkpoint.py``, with the same layout on disk).

Layout (one directory per step):
    <dir>/step_000000123/
        MANIFEST.json            # step, extras, each array's shape and dtype
        arrays.npz               # flat {path -> ndarray}
    <dir>/LATEST                 # atomic pointer (rename) to the newest step

Paths join dict keys (sorted) and sequence indices with "/", so a
``TrainState(params, OptState(step, m, v))`` saves ``0/...`` (params),
``1/0`` (step), ``1/1/...`` (m) and ``1/2/...`` (v), as the reference's
does: a checkpoint one package writes restores in the other when the
trees match.  bfloat16 (which npz cannot hold) widens to float32 on save,
losslessly, and narrows back to the template leaf's dtype on restore.
Arrays are saved whole; ``restore`` puts them on one device.  An async
save copies the tree to host memory first and writes on a background
thread; an error there surfaces at the next ``wait()`` (every ``save``
and ``restore`` waits first).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten_with_paths(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten_with_paths(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten_with_paths(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(paths: Dict[str, Any], template, fn) -> Any:
    """The structure of ``template`` with ``fn(template_leaf, array)`` at
    each leaf, the array taken from ``paths``."""
    def build(t, prefix=""):
        if isinstance(t, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            vals = [build(v, f"{prefix}{i}/") for i, v in enumerate(t)]
            return type(t)(*vals) if hasattr(t, "_fields") else \
                type(t)(vals)
        return fn(t, paths[prefix[:-1]])
    return build(template)


def _to_host(a) -> np.ndarray:
    """A host copy of ``a`` that shares no memory with it (``.cpu()`` of
    a CPU tensor would be the tensor itself), so that training may update
    the leaf in place while an async write runs."""
    if isinstance(a, torch.Tensor):
        # npz has no bf16: widen, losslessly
        dtype = torch.float32 if a.dtype == torch.bfloat16 else a.dtype
        return a.detach().to("cpu", dtype, copy=True).numpy()
    return np.array(a, copy=True)


def _to_tensor(template, a: np.ndarray, device) -> torch.Tensor:
    """``a`` as a tensor of the template leaf's dtype on ``device`` (the
    template's device by default)."""
    dev = device if device is not None else template.device
    t = torch.from_numpy(np.array(a))         # a copy that keeps 0-d
    return t.to(device=dev, dtype=template.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             async_: bool = False):
        """Snapshot ``tree`` (a tree of tensors or arrays) with
        JSON-serialisable extras.  The tree is copied to host memory before
        this returns, so training may update it while an async write
        runs."""
        self.wait()
        host = _flatten_with_paths(tree)
        host = {k: _to_host(v) for k, v in host.items()}

        def work():
            try:
                self._write(step, host, extra or {})
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if async_:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_if_failed()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _write(self, step: int, flat: Dict[str, np.ndarray], extra: Dict):
        name = f"step_{step:09d}"
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=f".{name}.")
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            manifest = {
                "step": step,
                "extra": extra,
                "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                           for k, v in flat.items()},
            }
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            final = os.path.join(self.dir, name)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                      # atomic publish
            self._point_latest(name)
            self._gc()
        finally:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp, ignore_errors=True)

    def _point_latest(self, name: str):
        ptr = os.path.join(self.dir, "LATEST")
        tmp = ptr + ".tmp"
        with open(tmp, "w") as f:
            f.write(name)
        os.replace(tmp, ptr)                           # atomic

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        ptr = os.path.join(self.dir, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            return int(f.read().strip().split("_")[1])

    def restore(self, template: Any, step: Optional[int] = None,
                device=None) -> Tuple[Any, Dict]:
        """Restore into the structure of ``template`` (a tree of tensors):
        each array cast to its template leaf's dtype and put on ``device``
        (each template leaf's own device by default).  Returns (tree,
        extras)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        name = f"step_{step:09d}"
        with open(os.path.join(self.dir, name, "MANIFEST.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(self.dir, name, "arrays.npz")) as data:
            flat = {k: data[k] for k in data.files}
        tree = _unflatten(flat, template,
                          lambda t, a: _to_tensor(t, a, device))
        return tree, manifest["extra"]
