"""Capture the exact prompts the benchmark pipeline hands the LLM (the
port's copy of ``scripts/harvest_pipeline_prompts.py``, on ``--device``).

    python -m gvl_tpu_torch.scripts.harvest_pipeline_prompts \
        --out data/training/pipeline_prompts.jsonl --per-loader 16 [--device cpu]

Real loader samples go through the real perception -> build_prompt path
and each (system, user, ground_truth) triple is written as one JSON line:
ground truth for a matching training family and a held-out evaluation
set for the next QA-LM rung.  Timelines come from the preset's perception
stack on ``--device`` (default ``cuda``; raises without a card unless
``cpu`` is asked for).
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

from gvl_tpu_torch import resolve_device

logger = logging.getLogger("harvest")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out",
                        default="data/training/pipeline_prompts.jsonl")
    parser.add_argument("--per-loader", type=int, default=16)
    parser.add_argument("--seeds", type=int, nargs="*", default=[42, 7])
    parser.add_argument("--config", default="synthetic_gate",
                        help="eval arm (prompt content is arm-independent"
                             " given the same capability toggles)")
    parser.add_argument("--preset", default="light")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    device = resolve_device(args.device)

    from gvl_tpu_torch.eval.loaders.base import BenchmarkConfig
    from gvl_tpu_torch.eval.loaders.glitchbench import GlitchBenchLoader
    from gvl_tpu_torch.eval.loaders.physgame import PhysGameLoader
    from gvl_tpu_torch.eval.model_configs import get_model_config
    from gvl_tpu_torch.eval.model_inference import FullPipelineRunner

    records = []
    for seed in args.seeds:
        for loader_cls in (GlitchBenchLoader, PhysGameLoader):
            loader = loader_cls(BenchmarkConfig(
                data_dir="/nonexistent", synthetic=True,
                random_seed=seed))
            samples = loader.synthetic_samples(args.per_loader)
            runner = FullPipelineRunner(get_model_config(args.config),
                                        preset=args.preset, device=device)
            for sample in samples:
                processed = runner._get_processed(str(sample.video_path))
                core = processed.loop.reasoning_core
                captured: dict = {}
                orig = core.backend.stream

                def capture(messages, config, inputs_embeds_prefix=None,
                            _c=captured):
                    _c["messages"] = [dict(m) for m in messages]
                    yield "**Answer:** (captured)"

                core.backend.stream = capture
                try:
                    runner.run_inference(sample)
                finally:
                    core.backend.stream = orig
                msgs = captured.get("messages")
                if not msgs:
                    logger.warning("no prompt captured for %s",
                                   sample.sample_id)
                    continue

                def text_of(m):
                    c = m.get("content")
                    if isinstance(c, str):
                        return c
                    return "\n".join(p.get("text", "") for p in c
                                     if isinstance(p, dict))

                system = next((text_of(m) for m in msgs
                               if m.get("role") == "system"), "")
                user = "\n".join(text_of(m) for m in msgs
                                 if m.get("role") == "user")
                records.append({
                    "sample_id": sample.sample_id,
                    "benchmark": sample.benchmark_name,
                    "seed": seed,
                    "system": system,
                    "user": user,
                    "question": sample.question,
                    "options": sample.options,
                    "ground_truth": sample.ground_truth,
                    "answer_format": sample.answer_format.value,
                    "video_path": sample.video_path,
                })
                logger.info("captured %s (%d user chars)",
                            sample.sample_id, len(user))

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    logger.info("wrote %d prompts to %s", len(records), out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
