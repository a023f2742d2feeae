"""Interactive gameplay-video QA: full perception → external memory → chat.

The port's copy of the JAX package's ``scripts/realtime_inference.py``
command line (``--video --preset --fps --query`` and the interactive slash
commands), over :mod:`gvl_tpu_torch.pipeline`::

    python -m gvl_tpu_torch.scripts.realtime_inference \\
        --video "synthetic://boss_fight?duration=10" --query "Does a boss appear?"

``--batched`` and ``--pipelined`` select the chunked and the stage-parallel
perception; ``--device`` is where every model runs (``cuda`` by default,
which raises without a card; ``cpu`` runs the plain versions).
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Optional

from gvl_tpu_torch.agent.search import GameDetector, GameKnowledgeSearcher
from gvl_tpu_torch.config import load_preset
from gvl_tpu_torch.pipeline import (
    DEFAULT_CONCEPTS,
    ProcessedVideo,
    answer_query_streaming,
    process_video,
)

HELP = """Commands:
  /clear            reset conversation
  /history          show conversation summary
  /save <path>      save conversation
  /load <path>      load conversation
  /game <name>      set the current game
  /search <query>   web search (general)
  /wiki /boss /lore <query>   category searches
  /status           loop status
  /quit             exit"""


def interactive_mode(processed: ProcessedVideo,
                     searcher: Optional[GameKnowledgeSearcher] = None) -> None:
    """Questions and ``/`` commands from stdin until ``/quit`` or EOF; the
    game searcher (``searcher``, else a new one) is detected from the
    timeline and handed to the reasoning core's tool calls."""
    searcher = searcher or GameKnowledgeSearcher()
    ctx = GameDetector().detect_from_timeline(processed.timeline)
    if ctx:
        searcher.game_context = ctx
        print(f"Detected game: {ctx.game_name} ({ctx.game_genre})")
    core = processed.loop.reasoning_core
    core._knowledge_searcher = searcher
    core.tool_parser._knowledge_searcher = searcher

    print("\nInteractive mode — ask about the video ('/help' for commands)")
    while True:
        try:
            line = input("\n> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not line:
            continue
        if line.startswith("/"):
            cmd, _, arg = line.partition(" ")
            if cmd == "/quit":
                break
            elif cmd == "/help":
                print(HELP)
            elif cmd == "/clear":
                core.clear_conversation()
                print("conversation cleared")
            elif cmd == "/history":
                print(core.get_conversation_summary())
            elif cmd == "/save":
                core.save_conversation(arg or "conversation.json")
            elif cmd == "/load":
                core.load_conversation(arg or "conversation.json")
            elif cmd == "/game":
                searcher.set_game_context(arg)
                print(f"game set: {arg}")
            elif cmd == "/status":
                print(processed.loop.get_status())
            elif cmd in ("/search", "/wiki", "/boss", "/lore"):
                category = cmd[1:] if cmd != "/search" else "general"
                print(searcher.execute_tool_call(arg, category))
            else:
                print(f"unknown command {cmd} — /help")
            continue
        ts = processed.loop.reasoning_core.retriever.parse_timestamp(line)
        t0 = time.perf_counter()
        for piece in answer_query_streaming(processed, line, ts):
            print(piece, end="", flush=True)
        print(f"\n[{time.perf_counter() - t0:.1f}s]")


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--video", required=True,
                        help="path, .y4m, or synthetic://scene?duration=..")
    parser.add_argument("--preset", default="light", choices=["light", "standard", "full"])
    parser.add_argument("--fps", type=float, default=None)
    parser.add_argument("--use-sam", action="store_true", default=None)
    parser.add_argument("--no-sam", dest="use_sam", action="store_false")
    parser.add_argument("--no-cache", action="store_true")
    parser.add_argument("--batched", action="store_true",
                        help="throughput-oriented batched perception (chunked device "
                             "calls; best for offline)")
    parser.add_argument("--pipelined", action="store_true",
                        help="stage-parallel perception (segment/semantic/OCR workers "
                             "with bounded queues)")
    parser.add_argument("--query", default=None,
                        help="one-shot question (skips interactive mode)")
    parser.add_argument("--concepts", nargs="*", default=DEFAULT_CONCEPTS)
    parser.add_argument("--device", default="cuda",
                        help="where the models run: cuda (default; raises without a "
                             "card) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    config = load_preset(args.preset)
    if args.fps is not None:
        config.inference.fps = args.fps
    if args.use_sam is not None:
        config.perception.use_sam = args.use_sam

    processed = process_video(
        args.video, config, use_cache=not args.no_cache, concepts=args.concepts,
        pipelined=args.pipelined, batched=args.batched, device=args.device)
    stats = processed.timeline.get_statistics()
    print(f"\nTimeline: {stats['total_events']} events, "
          f"{stats['unique_entities']} entities, "
          f"{stats['duration']:.0f}s span")

    if args.query:
        ts = processed.loop.reasoning_core.retriever.parse_timestamp(args.query)
        print()
        for piece in answer_query_streaming(processed, args.query, ts):
            print(piece, end="", flush=True)
        print()
        return 0

    interactive_mode(processed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
