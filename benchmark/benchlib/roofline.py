"""The match layer's roofline: the least time the card could take to read
what a search compares, from the cell's shapes alone.

Counted once a call: every stored fingerprint value that the mode compares
(tracks x frames x coefs x 4 B), each query's fingerprint (batch x frames x
coefs x 4 B) and the votes written (batch x tracks x 4 B), over the card's
HBM bandwidth. No structure the program builds (its sorted index, its kept
order, its work lists) and no operation count of any design enters it, so a
later kernel cannot make it stale. A search that reads only a certified
prefilter's candidates reads less than this; such a cell needs a count of
its own.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet: HBM3 at 3.35 TB/s (700 W)
HBM_BYTES_S = 3.35e12
VALUE_BYTES = 4  # float32 fingerprint values
VOTE_BYTES = 4  # int32 votes


def match_bytes(tracks: int, track_frames: int, query_frames: int,
                coefs: int, batch: int) -> int:
    return VALUE_BYTES * coefs * (tracks * track_frames
                                  + batch * query_frames) \
        + VOTE_BYTES * batch * tracks


def match_bound_ms(tracks: int, track_frames: int, query_frames: int,
                   coefs: int, batch: int) -> float:
    return match_bytes(tracks, track_frames, query_frames, coefs,
                       batch) / HBM_BYTES_S * 1e3
