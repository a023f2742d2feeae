"""The arm's runner: evaluation arms, synthetic benchmark samples and the
full-pipeline runner (the port's copy of what ``benchmarks/`` holds for
them)."""
