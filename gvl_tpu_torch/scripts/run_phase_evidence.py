"""Phase evidence in ONE process (the port's copy of
``scripts/run_phase_evidence.py``, on ``--device``).

    python -m gvl_tpu_torch.scripts.run_phase_evidence [--device cpu]

Runs phase 1 (glitchbench) and phase 3 (longvideobench) synthetic
evaluations for the ``qa_lm`` and ``gvp_light`` arms over three seeds,
writing results/phase{1,3}/seed<S>/ in the MetricsTracker layout, then
aggregates results/SUMMARY.md.  One process loads each arm's models once
for the whole sweep.
"""

from __future__ import annotations

import argparse
import logging
import time

from gvl_tpu_torch.eval import run_phase1, run_phase3

ARMS = ["qa_lm", "gvp_light"]
SEEDS = [0, 1, 2]
N = 32


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain "
                             "PyTorch path)")
    device = parser.parse_args(argv).device
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    logging.getLogger("gvl_tpu_torch").setLevel(logging.WARNING)
    t00 = time.time()
    for seed in SEEDS:
        for phase_mod, name, bench in (
                (run_phase1, "phase1", "glitchbench"),
                (run_phase3, "phase3", "longvideobench")):
            out = f"results/{name}/seed{seed}"
            t0 = time.time()
            rc = phase_mod.main([
                "--synthetic", "--configs", *ARMS,
                "--max-samples", str(N), "--seed", str(seed),
                "--shuffle", "--output-dir", out,
                "--benchmark", bench, "--device", device,
            ])
            print(f"[evidence] {name} seed {seed}: rc={rc} "
                  f"{time.time() - t0:.0f}s (total {time.time() - t00:.0f}s)",
                  flush=True)
            if rc not in (0, None):
                return int(rc)
    from gvl_tpu_torch.scripts.summarize_phase_results import main as summarize

    summarize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
