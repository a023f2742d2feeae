"""Serve the gameplay-video QA pipeline over HTTP (the port's copy of the
JAX package's ``scripts/deploy_api.py``)::

    python -m gvl_tpu_torch.scripts.deploy_api --port 8080 \\
        [--llm-checkpoint outputs/qa_lm [--int8]] [--device cpu]

``--llm-checkpoint`` takes a QA-model checkpoint directory (the
repository's own format, ``qa_lm_config.json`` + ``params.npz``) or an HF
``Qwen3ForCausalLM`` directory and serves it through the
continuous-batching engine (``POST /generate``, ``POST /chat``);
``--int8`` quantizes its weights per output channel (weight-only) first.
An HF directory without a tokenizer serves ``prompt_ids`` only.  Not
ported, and refused: ``--tp`` / ``--dp`` above 1 (ROADMAP A12).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

from gvl_tpu_torch.config import load_preset
from gvl_tpu_torch.serving.api import InferenceService, create_server

logger = logging.getLogger(__name__)


def _attach_llm(service: InferenceService, checkpoint: str, num_slots: int,
                int8: bool = False, tp: int = 1, dp: int = 1) -> None:
    """Load a QA-model checkpoint, or an HF Qwen3 checkpoint, on the
    service's device and serve it through the shared continuous-batching
    engine; ``int8`` quantizes the loaded weights per output channel
    (:func:`~gvl_tpu_torch.models.qwen3.quantize_int8`).  An HF directory's
    tokenizer serves string prompts; without one (a weights-only
    checkpoint) ``/generate`` takes ``prompt_ids`` only, and EOS is 151645."""
    from gvl_tpu_torch.models.byte_tokenizer import EOS_ID, ByteTokenizer
    from gvl_tpu_torch.models.qwen3 import load_hf_qwen3, quantize_int8
    from gvl_tpu_torch.models.session import Qwen3ChatSession
    from gvl_tpu_torch.serving import ContinuousBatchingEngine, EngineServer
    from gvl_tpu_torch.training.qa_lm_train import is_qa_lm_checkpoint, load_qa_lm

    if tp > 1 or dp > 1:
        raise NotImplementedError(
            f"--tp {tp} / --dp {dp}: multi-device serving is not ported yet (ROADMAP A12)")
    device = service.device
    if is_qa_lm_checkpoint(checkpoint):
        config, state = load_qa_lm(checkpoint, device=device)
        tokenizer, eos = ByteTokenizer(), EOS_ID
    else:
        config, state = load_hf_qwen3(checkpoint)
        state = {k: v.to(device) for k, v in state.items()}
        try:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(checkpoint)
        except Exception:  # weights-only checkpoint: serve prompt_ids
            logger.warning("no tokenizer at %s — /generate accepts prompt_ids only",
                           checkpoint)
            tokenizer = None
        eos = tokenizer.eos_token_id if tokenizer is not None else None
        eos = eos if eos is not None else 151645
    if int8:
        state = quantize_int8(state, config)
        config = dataclasses.replace(config, quant_int8=True, lora_rank=0)
    engine = ContinuousBatchingEngine(config, state, eos_token_id=eos,
                                      num_slots=num_slots, device=device)

    def session_factory():
        return Qwen3ChatSession(config, state, eos_token_id=eos, device=device)

    service.attach_engine(EngineServer(engine), tokenizer=tokenizer,
                          session_factory=session_factory)


def build_server(argv=None):
    """The HTTP server the command line would serve (not yet serving)."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument(
        "--host", default="127.0.0.1",
        help="bind address (default loopback — the API is unauthenticated and /process "
             "reads local paths; put a reverse proxy with auth in front before binding "
             "0.0.0.0)")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--preset", default="light", choices=["light", "standard", "full"])
    parser.add_argument("--llm-checkpoint", default=None,
                        help="QA-model or HF Qwen3 checkpoint dir; enables POST /generate "
                             "backed by the continuous-batching engine")
    parser.add_argument("--num-slots", type=int, default=8,
                        help="concurrent decode slots for /generate")
    parser.add_argument("--int8", action="store_true",
                        help="weight-only int8 quantize the LLM after load")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree (not ported: above 1 raises)")
    parser.add_argument("--dp", type=int, default=1,
                        help="data-parallel replicas (not ported: above 1 raises)")
    parser.add_argument("--device", default="cuda",
                        help="where the models run: cuda (default; raises without a "
                             "card) or cpu")
    args = parser.parse_args(argv)
    from gvl_tpu_torch import resolve_device

    service = InferenceService(load_preset(args.preset), device=resolve_device(args.device))
    if args.llm_checkpoint:
        _attach_llm(service, args.llm_checkpoint, args.num_slots, int8=args.int8,
                    tp=args.tp, dp=args.dp)
    elif args.tp > 1 or args.dp > 1:
        raise NotImplementedError(
            f"--tp {args.tp} / --dp {args.dp}: multi-device serving is not ported yet "
            "(ROADMAP A12)")
    return create_server(args.host, args.port, service)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    server = build_server(argv)
    host, port = server.server_address[:2]
    logger.info("serving on %s:%d", host, port)
    try:
        server.serve_forever()
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
