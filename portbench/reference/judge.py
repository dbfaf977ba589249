"""The comparison that decides ``correct``.

Every answer the window produced is judged against the reference: the
seed's vectors and queries are put in the index's stored space by the
frozen rules for the configuration's ``metric`` (``quant.stored``: the
8-bit rule, after unit normalization for ``"cosine"``), the exact top-k
found there in float64 (``exact.py``), and each answered row compared
with it. Under ``"cosine"`` the index returns L2 distances between its
stored unit vectors, so every check below reads those. The numbers, each
with its limit from the configuration's ``check``:

- ``recall_at_10``: mean over every answered query of |ids & exact| / k.
  The configuration's own guarantee (recall@10 >= 0.99) is its limit.
- ``dist_err``: the largest ``|d^2 - ref d^2| / (|q|^2 + |x|^2)`` over
  every returned (query, id, distance): the distance returned for an id
  must be that id's distance in the stored space, to float32 rounding.
- ``bad_rows``: rows missing, short, or holding an id outside [0, N) or
  a distance that is not finite. Limit 0.
- ``dup_rows``: rows that return one id twice. Limit 0.
- ``unsorted_rows``: rows whose distances fall somewhere. Limit 0.
"""

from __future__ import annotations

import numpy as np
import torch

from .exact import exact_topk, pair_d2
from .quant import stored


def limits(check: dict) -> dict:
    """(name -> (limit, "min" | "max")) from a configuration's ``check``."""
    return {"recall_at_10": (float(check["recall_at_10_min"]), "min"),
            "dist_err": (float(check["dist_err_max"]), "max"),
            "bad_rows": (0, "max"), "dup_rows": (0, "max"),
            "unsorted_rows": (0, "max")}


class Reference:
    """The seed's points and queries in the stored space of ``metric``
    (``"l2"`` or ``"cosine"``; any other raises), and their exact top-k,
    made once; :meth:`judge` compares any number of answers."""

    def __init__(self, train: np.ndarray, queries: np.ndarray, k: int,
                 device: torch.device, metric: str):
        self.k, self.device = k, device
        self.pts = stored(torch.from_numpy(train).to(device), metric)
        self.qs = stored(torch.from_numpy(queries).to(device), metric)
        self.truth = exact_topk(self.pts, self.qs, k)

    def judge(self, answers, rows_per_block: int = 1 << 16) -> dict:
        """``answers``: a list of ``(qidx int[B], dist [b, k], ids [b, k])``
        as the program returned them (``b`` < ``B`` counts the missing rows
        as bad). Returns the numbers above and ``attempted`` (rows due)."""
        k, device, n = self.k, self.device, self.pts.shape[0]
        hits = attempted = bad = dup = unsorted = 0
        err = 0.0
        blocks: list[tuple] = []
        for qidx, dist, ids in answers:
            qidx = np.asarray(qidx, np.int64)
            dist, ids = np.asarray(dist), np.asarray(ids)
            attempted += qidx.shape[0]
            if dist.ndim != 2 or ids.shape != dist.shape or ids.shape[1] != k:
                bad += qidx.shape[0]
                continue
            rows = min(ids.shape[0], qidx.shape[0])
            bad += qidx.shape[0] - rows
            blocks.append((qidx[:rows], dist[:rows], ids[:rows]))
        for qidx, dist, ids in _reblock(blocks, rows_per_block):
            qi = torch.from_numpy(qidx).to(device)
            d = torch.from_numpy(np.asarray(dist, np.float64)).to(device)
            i = torch.from_numpy(np.asarray(ids, np.int64)).to(device)
            ok = (i >= 0) & (i < n) & torch.isfinite(d)
            row_ok = ok.all(dim=1)
            bad += int((~row_ok).sum())
            i_safe = torch.where(ok, i, 0)
            hits += int(((i_safe[:, :, None] == self.truth[qi][:, None, :])
                         .any(-1) & ok).sum())
            s = torch.sort(torch.where(ok, i, -1 - torch.arange(k, device=device)),
                           dim=1).values
            dup += int(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any(dim=1).sum())
            unsorted += int(((d[:, 1:] < d[:, :-1]) & row_ok[:, None])
                            .any(dim=1).sum())
            ref, scale = pair_d2(self.pts, self.qs, qi, i_safe)
            e = torch.where(ok, (d * d - ref).abs() / scale.clamp_min(1e-30), 0.0)
            err = max(err, float(e.max()) if e.numel() else 0.0)
        return {"recall_at_10": hits / (k * attempted) if attempted else 0.0,
                "dist_err": err, "bad_rows": bad, "dup_rows": dup,
                "unsorted_rows": unsorted, "attempted": attempted}


def _reblock(blocks, rows):
    """Concatenate small answer blocks (one-query requests) into blocks of
    about ``rows`` rows, so the card sees few large gathers."""
    buf, size = [], 0
    for b in blocks:
        buf.append(b)
        size += b[0].shape[0]
        if size >= rows:
            yield tuple(np.concatenate(p) for p in zip(*buf))
            buf, size = [], 0
    if buf:
        yield tuple(np.concatenate(p) for p in zip(*buf))


def verdict(numbers: dict, lims: dict) -> tuple[bool, dict]:
    """(correct, name -> {"value", "limit"}) in the order of ``lims``."""
    shown, correct = {}, numbers["attempted"] > 0
    for name, (lim, side) in lims.items():
        v = numbers[name]
        correct &= v >= lim if side == "min" else v <= lim
        shown[name] = {"value": v, "limit": lim}
    return correct, shown
