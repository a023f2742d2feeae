"""Aggregate phase-run evidence across seeds into one table (the port's copy
of ``scripts/summarize_phase_results.py``; host code only).

    python -m gvl_tpu_torch.scripts.summarize_phase_results

Reads ``results/phase{1,3}/seed*/<phase>/aggregates.json`` +
``samples.json`` (the MetricsTracker layout) and writes
``results/SUMMARY.md`` with per-arm mean accuracy over seeds and the
per-family split the capability bars are graded on (binary / MCQ /
audio families for the qa_lm arm; concept-MCQ for gvp_light).
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from pathlib import Path

RESULTS = Path("results")


def _family(sample: dict) -> str:
    """Task family from the synthetic sample index (the loader's branch
    schedule, ``BenchmarkLoader.synthetic_samples`` in
    :mod:`gvl_tpu_torch.eval.loaders.base`): i%8==2 → audio
    implication, even i → binary presence, i%4==3 → audio-line MCQ,
    else → concept MCQ.  Non-synthetic ids fall back to task_type."""
    sid = sample.get("sample_id") or ""
    m = re.search(r"_synth_(\d+)$", sid)
    if not m:
        return (sample.get("task_type") or "other").lower()
    i = int(m.group(1))
    if i % 8 == 2:
        return "audio_imp"
    if i % 2 == 0:
        return "binary"
    if i % 4 == 3:
        return "audio_mcq"
    return "concept_mcq"


def main() -> int:
    rows = []
    per_family: dict[tuple, dict[str, list]] = defaultdict(
        lambda: defaultdict(list))
    acc: dict[tuple, list] = defaultdict(list)
    for phase_dir in sorted(RESULTS.glob("phase*")):
        for seed_dir in sorted(phase_dir.glob("seed*")):
            for agg_file in seed_dir.rglob("aggregates.json"):
                for a in json.loads(agg_file.read_text()):
                    key = (phase_dir.name, a["config_name"], a["benchmark"])
                    acc[key].append((seed_dir.name, a["accuracy"],
                                     a["num_samples"]))
            for s_file in seed_dir.rglob("samples.json"):
                for s in json.loads(s_file.read_text()):
                    key = (phase_dir.name, s["config_name"])
                    fam = _family(s)
                    if s.get("correct") is not None:
                        per_family[key][fam].append(bool(s["correct"]))

    lines = ["# Phase evaluation evidence (committed)", ""]
    lines.append("## Per-arm accuracy (mean over seeds)\n")
    lines.append("| phase | arm | benchmark | mean acc | per-seed | n/seed |")
    lines.append("|---|---|---|---|---|---|")
    for key in sorted(acc):
        vals = acc[key]
        mean = sum(v for _, v, _ in vals) / len(vals)
        per_seed = ", ".join(f"{s}={v:.3f}" for s, v, _ in vals)
        n = vals[0][2]
        lines.append(f"| {key[0]} | {key[1]} | {key[2]} | {mean:.3f} | "
                     f"{per_seed} | {n} |")
    lines.append("\n## Per-family correctness (pooled over seeds)\n")
    lines.append("| phase | arm | family | acc | n |")
    lines.append("|---|---|---|---|---|")
    for key in sorted(per_family):
        for fam, hits in sorted(per_family[key].items()):
            a = sum(hits) / len(hits)
            lines.append(f"| {key[0]} | {key[1]} | {fam} | {a:.3f} | "
                         f"{len(hits)} |")
    out = RESULTS / "SUMMARY.md"
    out.write_text("\n".join(lines) + "\n")
    print("\n".join(lines))
    print(f"\nwrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
