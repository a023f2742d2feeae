"""The ``gvp_full`` arm's toggles on the ``light`` preset (segmenter, region
embeddings on the mini-SigLIP, HiCo, projectors, 8 fps) through
gvl_tpu_torch's ``process_video`` and ``answer_query`` against
``scripts/realtime_inference.py`` on the trained weights of ``outputs/``
(HiCo ``outputs/hico_params.npz``, its CLIP level), on the CPU.
``test_torch_gvp_videomae.py`` runs the same with VideoMAE on.

One 4 s clip (32 frames: two segmented, one HiCo clip), ``use_cache=False``;
the comparisons of ``test_torch_gvp_light``: timelines, transcripts and
knowledge bases equal, embeddings within 1e-4 of their largest magnitude,
the grounded fake's messages and answers equal.
"""

from benchmarks.model_configs import get_model_config as jax_arm
from benchmarks.model_inference import FullPipelineRunner as JaxRunner
from gvl_tpu_torch import pipeline as tpipe
from gvl_tpu_torch.eval.model_configs import get_model_config as port_arm
from gvl_tpu_torch.eval.model_inference import FullPipelineRunner

from scripts import realtime_inference as jri
from test_torch_gvp_light import QUESTIONS, compare_answers, compare_processed

CLIP = "synthetic://concept_demo_full?duration=4&fps=8&entities=player,enemy,item"


def run_gvp_full(videomae: bool):
    jri._LOOP_COMPONENT_CACHE.clear()
    tpipe._LOOP_COMPONENT_CACHE.clear()
    jcfg = JaxRunner(jax_arm("gvp_full"), use_cache=False).preset
    tcfg = FullPipelineRunner(port_arm("gvp_full"), use_cache=False, device="cpu").preset
    for cfg in (jcfg, tcfg):
        cfg.perception.use_videomae = videomae
    assert (tcfg.perception.use_sam, tcfg.perception.use_siglip, tcfg.temporal.use_hico,
            tcfg.inference.fps) == (True, True, True, 8.0)
    try:
        jax_pv = jri.process_video(CLIP, jcfg, use_cache=False)
        port_pv = tpipe.process_video(CLIP, tcfg, use_cache=False, device="cpu")
        compare_processed(jax_pv, port_pv, {"visual", "temporal"})
        assert len(port_pv.timestamps) == 32
        assert ("videomae_embeddings" in port_pv.timings) == videomae
        hico = [e for e in port_pv.timeline.events
                if e.description.startswith("Temporal context")]
        assert len(hico) == 1
        if videomae:
            assert len(port_pv.videomae_embeddings) == 3
            assert port_pv.loop.config.videomae_dim == 256
        compare_answers(jax_pv, port_pv, QUESTIONS)
    finally:
        jri._LOOP_COMPONENT_CACHE.clear()
        tpipe._LOOP_COMPONENT_CACHE.clear()


def test_gvp_full_toggles_equal_on_trained_weights():
    run_gvp_full(videomae=False)
