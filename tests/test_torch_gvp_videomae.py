"""The ``gvp_full`` arm's toggles with ``perception.use_videomae`` on (the
setting of the ``standard`` and ``full`` presets) through gvl_tpu_torch's
``process_video`` against ``scripts/realtime_inference.py`` on the trained
weights of ``outputs/`` (clip classifier ``outputs/videomae``), on the CPU:
``test_torch_gvp_full``'s clip and comparisons, and three VideoMAE windows
whose clip embeddings (256 wide) and TEMPORAL motion events must match.
"""

from test_torch_gvp_full import run_gvp_full


def test_gvp_full_with_videomae_equal_on_trained_weights():
    run_gvp_full(videomae=True)
