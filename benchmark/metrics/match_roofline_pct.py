"""The match layer's device time a call against the least time the card
could read what the search compares (benchlib/roofline.py, from the cell's
shapes), in %. Nothing where the traced calls ran no match operation."""

from benchlib.judge import track_samples
from benchlib.roofline import match_bound_ms


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.layer_ms("match")
    if not ms:
        return None
    cfg, mix = run.cell.config, run.cell.traffic
    hop = int(cfg["dsp"]["hop_size"])
    bound = match_bound_ms(
        tracks=int(cfg["catalog"]["tracks"]),
        track_frames=track_samples(cfg) // hop,
        query_frames=-(-int(mix["window_samples"]) // hop),
        coefs=int(cfg["match"]["coefs"]), batch=int(mix["batch"]))
    return 100.0 * bound / ms
