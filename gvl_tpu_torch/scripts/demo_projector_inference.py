"""Demo: saved embeddings → ProjectorBank → reasoning loop, on ``--device``
(the port's copy of ``scripts/demo_projector_inference.py``).

    python -m gvl_tpu_torch.scripts.demo_projector_inference \
        --embeddings <clip>_embeddings.npz [--device cpu]

Loads ``*_embeddings.npz`` (or the ``.pt`` layout), projects into LLM
space, and runs one forced reasoning pass with embedding injection.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
import torch

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.agent import PerceptionReasoningLoop
from gvl_tpu_torch.fusion import ModalityType, TimelineIndexer


def load_embeddings(path: Path) -> dict:
    if path.suffix == ".pt":
        blob = torch.load(path, map_location="cpu", weights_only=True)
        return {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
                for k, v in blob.items()}
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--embeddings", required=True,
                        help="*_embeddings.npz or reference .pt")
    parser.add_argument("--projector-weights", default=None)
    parser.add_argument("--query",
                        default="Summarize what happens in this video.")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain "
                             "PyTorch path)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)

    data = load_embeddings(Path(args.embeddings))
    siglip = np.asarray(data.get("siglip", np.zeros((0, 1152), np.float32)))
    videomae = np.asarray(data.get("videomae", np.zeros((0, 768), np.float32)))
    audio = np.asarray(data.get("wav2vec2", data.get(
        "audio", np.zeros((0, 1024), np.float32))))
    print(f"loaded embeddings: siglip={siglip.shape} videomae={videomae.shape}"
          f" audio={audio.shape}")

    timeline = TimelineIndexer()
    for i, ts in enumerate(np.asarray(data.get("siglip_ts", []))[:50]):
        timeline.add_event(float(ts), ModalityType.VISUAL,
                           f"visual region observation {i}")

    # projector head dims follow the DATA (a trained clip tower emits
    # its own width, not the hash-fake/reference 768)
    from gvl_tpu_torch.agent.config import ReasoningCoreConfig

    rc = ReasoningCoreConfig()
    if len(siglip):
        rc.siglip_dim = int(siglip.shape[-1])
    if len(videomae):
        rc.videomae_dim = int(videomae.shape[-1])
    if len(audio):
        rc.audiomae_dim = int(audio.shape[-1])

    loop = PerceptionReasoningLoop(
        config=rc,
        timeline_indexer=timeline,
        projector_weights_path=args.projector_weights,
        device=device,
    )
    loop.start()
    loop.set_query(args.query)
    response = loop.process_frame(
        timestamp=0.0,
        region_embeddings=siglip[:16] if len(siglip) else None,
        videomae_embeddings=videomae[:16] if len(videomae) else None,
        audio_embeddings=audio[:16] if len(audio) else None,
        force_reason=True,
    )
    print("\n" + (response or "[no response]"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
