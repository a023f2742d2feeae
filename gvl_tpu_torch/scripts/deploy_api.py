"""Serve the gameplay-video QA pipeline over HTTP (the port's copy of the
JAX package's ``scripts/deploy_api.py``)::

    python -m gvl_tpu_torch.scripts.deploy_api --port 8080 \\
        [--llm-checkpoint outputs/qa_lm [--int8]] [--device cpu]

``--llm-checkpoint`` takes a QA-model checkpoint directory (the
repository's own format, ``qa_lm_config.json`` + ``params.npz``) or an HF
``Qwen3ForCausalLM`` directory and serves it through the
continuous-batching engine (``POST /generate``, ``POST /chat``);
``--int8`` quantizes its weights per output channel (weight-only) first.
An HF directory without a tokenizer serves ``prompt_ids`` only.

``--tp`` / ``--dp`` serve the model tensor- and data-parallel over a
``(dp, tp)`` mesh, one process per rank::

    torchrun --nproc-per-node <dp*tp> -m gvl_tpu_torch.scripts.deploy_api \\
        --tp 2 --dp 1 --llm-checkpoint outputs/qa_lm

Rank 0 serves HTTP; the other ranks follow the batching engine's steps
(:meth:`~gvl_tpu_torch.serving.batch_engine.ContinuousBatchingEngine.follow`)
until rank 0 stops (SIGTERM or SIGINT to rank 0 ends every rank).  A
``POST /chat`` turn runs in the engine's step on every rank, each on its
shard of the weights; a failed prefill fails its request alone, and a
failed step fails the live requests and rebuilds the cache, on every rank
alike.  The
mesh is fitted to the world's size as JAX fits it to the attached devices;
the backend follows the layout (NCCL with a card per rank, gloo when ranks
share a card).  Without a distributed launch, ``--tp`` / ``--dp`` above 1
raise, naming the launch line.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import logging
import os
import signal

from gvl_tpu_torch.config import load_preset
from gvl_tpu_torch.serving.api import InferenceService, create_server

logger = logging.getLogger(__name__)


def _mesh(tp: int, dp: int, device):
    """The ``(dp, tp)`` mesh of a distributed launch (None for 1 x 1);
    raises without one."""
    from gvl_tpu_torch.parallel.mesh import MeshManager, build_mesh, init_distributed

    if tp <= 1 and dp <= 1:
        return None
    # an idle server waits on rank 0 for hours: no collective timeout
    if not init_distributed(device=device, timeout=datetime.timedelta(days=365)):
        raise RuntimeError(
            f"--tp {tp} / --dp {dp} need one process per rank; launch with: "
            f"torchrun --nproc-per-node {dp * tp} -m gvl_tpu_torch.scripts.deploy_api "
            f"--tp {tp} --dp {dp} --llm-checkpoint <dir>")
    mesh = MeshManager(build_mesh(data=dp, model=tp))
    logger.info("LLM dp x tp serving over %s", mesh.describe())
    return mesh


def _attach_llm(service: InferenceService, checkpoint: str, num_slots: int,
                int8: bool = False, mesh=None):
    """Load a QA-model checkpoint, or an HF Qwen3 checkpoint, on the
    service's device and serve it through the shared continuous-batching
    engine; ``int8`` quantizes the loaded weights per output channel
    (:func:`~gvl_tpu_torch.models.qwen3.quantize_int8`).  An HF directory's
    tokenizer serves string prompts; without one (a weights-only
    checkpoint) ``/generate`` takes ``prompt_ids`` only, and EOS is 151645.
    ``mesh``: serve DP x TP, ``POST /chat`` through the engine's lockstep
    turns.  Returns the engine."""
    from gvl_tpu_torch.models.byte_tokenizer import EOS_ID, ByteTokenizer
    from gvl_tpu_torch.models.qwen3 import load_hf_qwen3, quantize_int8
    from gvl_tpu_torch.models.session import Qwen3ChatSession
    from gvl_tpu_torch.serving import ContinuousBatchingEngine, EngineServer
    from gvl_tpu_torch.training.qa_lm_train import is_qa_lm_checkpoint, load_qa_lm

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
                                      num_slots=num_slots, device=device, mesh=mesh)
    if mesh is not None and mesh.rank != 0:
        return engine            # a follower serves no HTTP

    # an engine on a mesh runs /chat turns itself, in its step on every rank
    session_factory = None if mesh is not None else (
        lambda: Qwen3ChatSession(config, state, eos_token_id=eos, device=device))
    service.attach_engine(EngineServer(engine), tokenizer=tokenizer,
                          session_factory=session_factory)
    return engine


class Follower:
    """What a rank other than 0 serves: the engine's steps, as rank 0
    runs them."""

    server_address = None

    def __init__(self, engine):
        self.engine = engine

    def serve_forever(self) -> None:
        self.engine.follow()

    def server_close(self) -> None:
        pass


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
                        help="tensor-parallel degree: shard the LLM over this many "
                             "ranks (one process each, under torchrun)")
    parser.add_argument("--dp", type=int, default=1,
                        help="data-parallel replicas: decode slots shard over the mesh's "
                             "data axis (num-slots must divide over dp)")
    parser.add_argument("--device", default="cuda",
                        help="where the models run: cuda (default; raises without a "
                             "card) or cpu")
    args = parser.parse_args(argv)
    from gvl_tpu_torch import resolve_device

    mesh = _mesh(args.tp, args.dp, args.device)
    if mesh is not None and not args.llm_checkpoint:
        raise ValueError(f"--tp {args.tp} / --dp {args.dp} shard the LLM: pass "
                         "--llm-checkpoint")
    device = mesh.device if mesh is not None else resolve_device(args.device)
    service = InferenceService(load_preset(args.preset), device=device)
    engine = None
    if args.llm_checkpoint:
        engine = _attach_llm(service, args.llm_checkpoint, args.num_slots,
                             int8=args.int8, mesh=mesh)
    if mesh is not None and mesh.rank != 0:
        return Follower(engine)
    server = create_server(args.host, args.port, service)
    server.engine = engine
    return server


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    from gvl_tpu_torch.parallel.mesh import shutdown_distributed

    server = build_server(argv)
    if isinstance(server, Follower):
        server.serve_forever()
        shutdown_distributed()
        return 0
    host, port = server.server_address[:2]
    # SIGTERM ends rank 0 as Ctrl-C does, so that its followers are released
    signal.signal(signal.SIGTERM, _interrupt)
    logger.info("serving on %s:%d (pid %d)", host, port, os.getpid())
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("stopping")
    finally:
        server.server_close()
        stop_engine(server)
        shutdown_distributed()
    return 0


def stop_engine(server) -> None:
    """Stop the engine's driver and release the followers (rank 0)."""
    engine = getattr(server, "engine", None)
    engine_server = getattr(server.service, "_engine_server", None)
    if engine_server is not None:
        engine_server.shutdown()
    if engine is not None:
        engine.release_followers()


if __name__ == "__main__":
    raise SystemExit(main())
