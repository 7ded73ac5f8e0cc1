"""What decides ``correct``: the reference's view of the served tokens.

Once the window has closed, a sample drawn from the seed of the requests
finished in it, with the longest among them, is run through the plain
reference over each prompt and its served tokens.  At each served token
the reference's logits say how far that token lies below the reference's
best; the widest such gap over the sample is compared with the cell's
limit.  Greedy decoding only: the program's token is its argmax.
"""

from __future__ import annotations

import numpy as np

from lutvq_bench.core.traffic import seed_key


def sample(finished: list, count: int, seed: int) -> list:
    """``count`` finished requests: the one with the most prompt and served
    tokens, and the rest drawn from the seed."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (len(r.prompt) + len(r.output), r.req_id))
    rest = [r for r in finished if r is not longest]
    rng = np.random.default_rng([seed_key(seed), 2])
    pick = rng.choice(len(rest), size=min(count - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[int(i)] for i in sorted(pick)]


def sequences(requests: list, device) -> tuple[list, list]:
    """Each request's prompt and served tokens but the last, and the
    positions whose logits chose the served tokens."""
    import torch

    seqs, pos = [], []
    for r in requests:
        toks = list(r.prompt) + list(r.output[:-1])
        seqs.append(torch.tensor(toks, dtype=torch.long, device=device))
        t0 = len(r.prompt)
        pos.append(torch.arange(t0 - 1, t0 - 1 + len(r.output), device=device))
    return seqs, pos


def gaps(ref_logits: list, chosen: list) -> list[float]:
    """Per position, the reference's best logit minus its logit of the
    chosen token (0 where they agree)."""
    import torch

    out = []
    for lg, tok in zip(ref_logits, chosen):
        tok = torch.as_tensor(tok, dtype=torch.long, device=lg.device)
        g = lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0]
        out.extend(g.tolist())
    return out
