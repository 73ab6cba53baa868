"""Faults planted under the timed path (by ``monkeypatch``, before the
replica is built), for the tests that see ``correct`` come out false:

* ``altered_token``: a token altered where it is produced (the sampler's
  pick moved by one);
* ``state_unchanged``: a decode step that returns its state unchanged
  (the cache and the positions restored after the step; it copies the
  whole cache, so it fits the reduced sizes only);
* ``half_batch``: half of the batch left out (the second half of the rows
  given the first row's logits).
"""
import torch


def altered_token(monkeypatch):
    from repro_torch.serving import engine
    orig = engine._argmax
    monkeypatch.setattr(engine, "_argmax", lambda logits: (
        orig(logits) + 1) % logits.shape[-1])


def state_unchanged(monkeypatch):
    from repro_torch.models import transformer
    orig = transformer.decode_step

    def step(cfg, params, batch, cache):
        keep = {k: ({l: t.clone() for l, t in v.items()}
                    if isinstance(v, dict) else v.clone())
                for k, v in cache.items()}
        logits, _ = orig(cfg, params, batch, cache)
        for k, v in keep.items():
            if isinstance(v, dict):
                for l, t in v.items():
                    cache[k][l].copy_(t)
            else:
                cache[k].copy_(v)
        return logits, cache
    monkeypatch.setattr(transformer, "decode_step", step)


def half_batch(monkeypatch):
    from repro_torch.models import transformer
    orig = transformer.decode_step

    def step(cfg, params, batch, cache):
        logits, cache = orig(cfg, params, batch, cache)
        half = logits.shape[0] // 2
        return torch.cat([logits[:half],
                          logits[:1].expand(logits.shape[0] - half, -1)]), \
            cache
    monkeypatch.setattr(transformer, "decode_step", step)
