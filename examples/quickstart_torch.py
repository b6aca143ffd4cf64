#!/usr/bin/env python3
"""Five-minute tour of the PyTorch port's library API.

Builds a small corpus, ingests it, and runs every kind of search the
engine offers, on the card (``--device cpu`` for the plain PyTorch
versions of the kernels). Run from the repo root:

    python examples/quickstart_torch.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tiresias_tpu_torch.api import Tiresias  # noqa: E402
from tiresias_tpu_torch.config import ContextConfig, TiresiasConfig  # noqa: E402
from tiresias_tpu_torch.utils.audio import synth_chirp, write_wav  # noqa: E402

SR = 8000

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
device = ap.parse_args().device

media = tempfile.mkdtemp(prefix="tiresias_media")
data = tempfile.mkdtemp(prefix="tiresias_data")
for i in range(5):
    write_wav(os.path.join(media, f"prompt{i}.wav"),
              synth_chirp(200 + 120 * i, 900 + 180 * i, 2.0, SR), SR)

config = TiresiasConfig(
    contexts=(ContextConfig("media", media),),
    data_dir=data,
)

with Tiresias(config, device=device) as eng:
    print("sync:", eng.sync())                    # init_context/init_audio

    # 1. file search — the Tiresias() dialplan contract
    res = eng.search_file("media", os.path.join(media, "prompt2.wav"),
                          coefs=2, tolerance=0.05, trunc_coef1=False)
    print("file search:", res.status, res.name,
          f"confidence={res.confidence:.2f}")
    print("channel vars:", res.to_channel_vars())

    # 2. direct PCM — no temp files
    res = eng.search_pcm("media", synth_chirp(440, 1260, 2.0, SR), SR,
                         coefs=2, tolerance=0.05, trunc_coef1=False)
    print("pcm search:", res.status, res.name)

    # 3. ranked candidates
    for rank, r in enumerate(eng.search_pcm_topk(
            "media", synth_chirp(440, 1260, 2.0, SR), SR, k=3,
            coefs=2, tolerance=0.5, trunc_coef1=False), 1):
        print(f"  top-{rank}: {r.name} votes={r.match_count}")

    # 4. catalog admin (the CLI's library equivalents)
    print("contexts:", [c["name"] for c in eng.get_contexts()])
    print("audios:", [e.name for e in eng.get_audios("media")])

print("checkpointed to", data, "- a fresh Tiresias(config) restores it")
