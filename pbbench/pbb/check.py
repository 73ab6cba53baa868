"""Whether what the timed path served is correct.

Once the window has closed and the program's state is freed, a sample of
the requests the program finished, drawn from the seed and holding the
longest of them and some of every adapter's, is run through the plain
reference (``reference/<module>.py``) with the tokens the program served.
For each served token the reference gives the gap by which its logit of
that token lies below its own best logit at that position; the widest gap
over the sample is compared with the cell's limit.  Greedy decoding picks
the best logit, so only rounding lets a served token lie below the
reference's best; a wrong cache row, a wrong adapter, a token altered or
a step that left its state unchanged put tokens far below it.

Each cell's traffic file names the numbers it compares and their limits
(``check.limits``): the widest gap over the sample (``gap_max``), the
mean gap over its served tokens (``gap_mean``), or the largest of its
requests' own mean gaps (``request_gap_mean_max``, which a fault in one
request's slot moves without the other requests' tokens diluting it).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from pbb import manifest, traffic


def sample(finished: Sequence, seed: int, per_adapter: int) -> List:
    """``per_adapter`` finished requests of each adapter, drawn from the
    seed, and the one with the longest output.  ``finished`` holds
    (request, served tokens) pairs."""
    if not finished:
        return []
    rng = traffic.stream(seed, 6)
    longest = max(range(len(finished)), key=lambda i: len(finished[i][1]))
    picked = {longest}
    groups: Dict = {}
    for i, (req, _) in enumerate(finished):
        groups.setdefault(req.adapter, []).append(i)
    for name in sorted(groups, key=str):
        idx = groups[name]
        picked.update(int(i) for i in rng.permutation(idx)[:per_adapter])
    return [finished[i] for i in sorted(picked)]


def _stats(prefix: str, gaps: List[torch.Tensor]) -> Dict[str, float]:
    """``gaps`` holds one tensor a request."""
    g = torch.cat(gaps) if gaps else torch.zeros(1)
    per = [float(x.mean()) for x in gaps] or [0.0]
    return {f"{prefix}gap_max": float(g.max()),
            f"{prefix}gap_mean": float(g.mean()),
            f"{prefix}request_gap_mean_max": max(per),
            f"{prefix}off_best_share": float((g > 0).float().mean())}


def judge(m: Dict, params: Dict, loras: Dict, items: Sequence,
          device, control: bool = False) -> Dict[str, float]:
    """The widest gap over ``items`` ((request, served tokens) pairs), the
    mean gap, the largest of the requests' own mean gaps and the share of
    served tokens off the reference's best, the
    served tokens covered and those outside the vocabulary, and where the
    widest gap lies; with ``control`` the same of the tokens the fp8
    control puts first at the same positions."""
    ref = manifest.reference(m)
    groups: Dict[Optional[str], List] = {}
    for req, served in items:
        groups.setdefault(req.adapter, []).append((req, served))
    served_gaps, ctl_gaps, where, widest = [], [], "", -1.0
    with torch.no_grad(), ref.no_tf32():
        for name, group in groups.items():
            lora = None if name is None else {
                "rank": m["lora"]["rank"], "alpha": m["lora"]["alpha"],
                "factors": loras[name]}
            seqs = []
            for req, served in group:
                toks = np.concatenate([req.prompt, np.asarray(served[:-1],
                                                              np.int64)])
                seqs.append((torch.from_numpy(toks).to(device),
                             len(req.prompt)))
            hidden = [h[p - 1:] for h, (_, p) in zip(
                ref.final_hidden(m, params, seqs, lora), seqs)]
            picks = [torch.as_tensor(s, dtype=torch.long, device=device)
                     for _, s in group]
            for (req, _), g in zip(group, ref.gaps(m, params, hidden,
                                                   picks)):
                g = g.cpu()
                if float(g.max()) > widest:
                    widest = float(g.max())
                    where = (f"request {req.rid} ({name or 'base'}, prompt "
                             f"{len(req.prompt)}) token {int(g.argmax())} "
                             f"of {g.numel()}")
                served_gaps.append(g)
            if control:
                ch = [h[p - 1:] for h, (_, p) in zip(
                    ref.final_hidden(m, params, seqs, lora, control=True),
                    seqs)]
                tops = ref.top_tokens(m, params, ch, control=True)
                ctl_gaps += [g.cpu() for g in ref.gaps(m, params, hidden,
                                                        tops)]
    out = _stats("", served_gaps)
    allg = torch.cat(served_gaps) if served_gaps else torch.zeros(0)
    out.update(tokens_checked=float(allg.numel()),
               requests_checked=float(len(items)),
               tokens_outside_vocab=float(torch.isinf(allg).sum()),
               widest_at=where)
    if control:
        out.update(_stats("control_", ctl_gaps))
    return out


def judge_run(srv, finished: Sequence, seed: int, spec: Dict,
              control: bool = False) -> Dict[str, float]:
    """``judge`` over the sample the cell's traffic file asks for, of the
    requests that a run of ``srv`` (a ``serve.Server`` whose program state
    is freed) finished."""
    items = sample(finished, seed, spec["check"]["per_adapter"])
    return judge(srv.m, srv.params, srv.loras, items, srv.device, control)


def verdict(got: Dict, spec: Dict):
    """(each number compared beside its limit, whether all hold): the
    numbers the cell's traffic file names, no served token outside the
    vocabulary, at least one request checked."""
    checks = {name: {"value": got[name], "limit": lim}
              for name, lim in spec["check"]["limits"].items()}
    checks["tokens_outside_vocab"] = {
        "value": got["tokens_outside_vocab"], "limit": 0}
    checks["requests_checked"] = {"value": got["requests_checked"],
                                  "least": 1}
    correct = all(c["value"] <= c["limit"] if "limit" in c
                  else c["value"] >= c["least"] for c in checks.values())
    return checks, correct
