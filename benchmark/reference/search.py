"""Tolerance votes and the TIR* top-1 in plain PyTorch: the benchmark's
reference for what a search answers (PARITY.md sections 3, D8 and D9 of
the repository state the semantics).

For a query ``q [F, C]`` (its real frames) and stored rows ``db [R, T, C]``
with ``mask [R, T]`` (a row's real frames):

    ok[r, f, t] = mask[r, t] and |q[f, c] - db[r, t, c]| <= tol
                  for every c < coefs (each difference in float32)
    bag:      votes[r] = sum_f any_t ok[r, f, t]
    aligned:  votes[r] = max_o sum_f ok[r, f, o + f]   (o over every shift)

The answer is the row of the most votes, the lowest row among equals (rows
in insertion order), FOUND with that count when it is above 0, NOTFOUND with
0 otherwise; its frame count is the query's. Brute force over every pair of
frames, in blocks of rows; it imports nothing of the program.

With ``slack = (sign, eq [F, C], ed [R, T, C])`` a pair's test is
``|q - d| <= tol + sign * (eq + ed)``: with sign -1 the votes no
fingerprints within ``eq``, ``ed`` of ``q``, ``db`` can fall below, with
sign +1 those they cannot pass.
"""

from __future__ import annotations

import torch


def votes(q: torch.Tensor, db: torch.Tensor,
          mask: torch.Tensor, tolerance: float, coefs: int, aligned: bool,
          rows_per_block: int = 512, slack=None) -> torch.Tensor:
    """``[R]`` int32 votes of one query against every stored row."""
    f_len = q.shape[0]
    r_len, t_len, _ = db.shape
    tol = torch.tensor(tolerance, dtype=torch.float32, device=db.device)
    q = q.to(torch.float32)
    out = torch.zeros(r_len, dtype=torch.int32, device=db.device)
    for lo in range(0, r_len, rows_per_block):
        d = db[lo: lo + rows_per_block].to(torch.float32)
        n = d.shape[0]
        ok = mask[lo: lo + n, None, :].expand(-1, f_len, -1).clone()
        for c in range(coefs):
            gap = (q[None, :, c, None] - d[:, None, :, c]).abs()
            if slack is None:
                ok &= gap <= tol
            else:
                sign, eq, ed = slack
                ok &= gap <= tol + sign * (eq[None, :, c, None]
                                           + ed[lo: lo + n, None, :, c])
        if not aligned:
            out[lo: lo + n] = ok.any(dim=2).sum(dim=1)
            continue
        # frame f's hit at stored frame t lands on shift o = t - f + F - 1:
        # with the frames reversed (g = F - 1 - f) and each row padded to
        # T + F, reading the rows at a stride of T + F - 1 moves row g's
        # frame t to column t + g = o
        skew = torch.nn.functional.pad(ok.flip(1), (0, f_len))
        skew = skew.reshape(n, -1)[:, : f_len * (t_len + f_len - 1)]
        acc = skew.reshape(n, f_len, t_len + f_len - 1).sum(
            dim=1, dtype=torch.int32)
        out[lo: lo + n] = acc.amax(dim=1)
    return out


def top1(v: torch.Tensor) -> tuple[int, int]:
    """(row, votes) of the answer; row -1 (and 0 votes) when no row got a
    vote."""
    best = int(v.max()) if v.numel() else 0
    if best <= 0:
        return -1, 0
    return int(torch.nonzero(v == best)[0, 0]), best
