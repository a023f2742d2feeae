"""LoRA SFT on chat-format Q&A data (the port's copy of
``scripts/finetune_lora.py``, on ``--device``).

    python -m gvl_tpu_torch.scripts.finetune_lora --data pairs.json [--device cpu]
    python -m gvl_tpu_torch.scripts.finetune_lora --qa-lm outputs/qa_lm [--device cpu]

r=32/alpha=64 on all seven targets, lr 2e-5, the mean of 8 gradients per
update; ``--dry-run`` validates the data and its tokenization only.
``--data`` trains the tiny random model over the word-hash tokenizer
unless ``--llm-checkpoint`` names a local HF Qwen3 directory (read with
``transformers``, its tokenizer too); ``--qa-lm`` LoRA-tunes the trained
byte QA model on the held-out causal family and measures base and adapter
through the real engine.  The adapter is written in the JAX package's
layout.  ``--device`` defaults to ``cuda`` and raises without a card
unless ``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import json
import logging
from dataclasses import replace

import torch

from gvl_tpu_torch import resolve_device

logger = logging.getLogger("finetune_lora")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data", default=None,
                        help="chat-format training JSON")
    parser.add_argument("--qa-lm", default=None, metavar="BASE_DIR",
                        help="LoRA-tune the self-trained byte QA LM on the "
                             "held-out causal family; streams generated "
                             "samples instead of --data")
    parser.add_argument("--steps", type=int, default=1500,
                        help="--qa-lm mode: LoRA SFT steps")
    parser.add_argument("--eval-samples", type=int, default=60,
                        help="--qa-lm mode: held-out eval size per arm")
    parser.add_argument("--output-dir", default="outputs/lora_adapter")
    parser.add_argument("--llm-checkpoint", default=None,
                        help="HF Qwen3 checkpoint dir; a tiny random model "
                             "is used without it (pipeline validation)")
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--lr", type=float, default=2e-5)
    parser.add_argument("--lora-rank", type=int, default=32)
    parser.add_argument("--lora-alpha", type=float, default=64.0)
    parser.add_argument("--max-seq-len", type=int, default=4096)
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    device = resolve_device(args.device)

    if args.qa_lm:
        return _finetune_qa_lm(args, device)

    if not args.data:
        print("--data is required (or use --qa-lm)")
        return 1

    from gvl_tpu_torch.models.qwen3 import Qwen3Config, init_jax_params
    from gvl_tpu_torch.training import LoraTrainer, LoraTrainingConfig, load_chat_training_data

    data = load_chat_training_data(args.data)
    if not data:
        print("no valid training samples")
        return 1

    lora = dict(lora_rank=args.lora_rank, lora_alpha=args.lora_alpha)
    if args.llm_checkpoint:
        from transformers import AutoTokenizer

        from gvl_tpu_torch.models.qwen3 import load_hf_qwen3

        base_cfg, base = load_hf_qwen3(args.llm_checkpoint)
        cfg = replace(base_cfg, **lora)
        # the base weights beside a fresh pair on every target
        drawn = init_jax_params(cfg, torch.Generator().manual_seed(0), "cpu")
        params = {**drawn, **base}
        tokenize = AutoTokenizer.from_pretrained(args.llm_checkpoint).encode
    else:
        from gvl_tpu_torch.models.sam import hash_tokenize

        cfg = Qwen3Config.tiny(max_cache_length=args.max_seq_len, **lora)
        params = init_jax_params(cfg, torch.Generator().manual_seed(0), "cpu")

        def tokenize(text):
            return hash_tokenize(text, cfg.vocab_size, 64).tolist()

    trainer = LoraTrainer(
        cfg, params, tokenize,
        LoraTrainingConfig(
            lora_rank=args.lora_rank, lora_alpha=args.lora_alpha,
            learning_rate=args.lr, epochs=args.epochs,
            max_seq_len=min(args.max_seq_len, 512 if not args.llm_checkpoint
                            else args.max_seq_len),
            output_dir=args.output_dir,
        ),
        device=device,
    )

    if args.dry_run:
        print(json.dumps(trainer.dry_run(data), indent=2))
        return 0

    result = trainer.train(data)
    print(f"done: {result['steps']} steps, final loss "
          f"{result['final_loss']:.4f} -> {args.output_dir}")
    return 0


def _finetune_qa_lm(args, device) -> int:
    """The adapter teaches the trained byte QA LM the held-out causal
    family; base and adapter accuracies on it and on the base mix are
    measured through the real engine and stored in adapter_config.json."""
    import time

    from gvl_tpu_torch.models.byte_tokenizer import EOS_ID
    from gvl_tpu_torch.models.qwen3 import Qwen3Engine, merge_lora
    from gvl_tpu_torch.training.qa_lm_train import (
        LoraQAConfig,
        evaluate_qa_lm,
        load_qa_lm,
        save_qa_lm_adapter,
        train_qa_lm_lora,
    )

    def accuracy(engine, **kw):
        out = evaluate_qa_lm(n_samples=args.eval_samples, engine=engine, **kw)
        return {k: v for k, v in out.items() if k not in ("answers", "families")}

    base_cfg, base_params = load_qa_lm(args.qa_lm, device=device)
    logger.info("eval base model (no adapter)...")
    base_engine = Qwen3Engine(base_cfg, base_params, eos_token_id=EOS_ID, device=device)
    base_causal = accuracy(base_engine, families=("causal",))
    base_mix = accuracy(base_engine)
    logger.info("base: causal=%.3f mix=%.3f",
                base_causal["accuracy"], base_mix["accuracy"])
    del base_engine

    lora_lr = args.lr if args.lr != 2e-5 else LoraQAConfig.learning_rate
    cfg = LoraQAConfig(steps=args.steps, learning_rate=lora_lr,
                       lora_rank=args.lora_rank, lora_alpha=args.lora_alpha)
    t0 = time.time()
    lora_cfg, lora_params = train_qa_lm_lora(args.qa_lm, cfg, device=device)
    logger.info("lora trained in %.1f s", time.time() - t0)

    merged = merge_lora(lora_params, lora_cfg)
    lora_engine = Qwen3Engine(replace(lora_cfg, lora_rank=0), merged, eos_token_id=EOS_ID,
                              device=device)
    lora_causal = accuracy(lora_engine, families=("causal",))
    lora_mix = accuracy(lora_engine)

    metrics = {
        "base_causal": base_causal, "base_mix": base_mix,
        "lora_causal": lora_causal, "lora_mix": lora_mix,
        "steps": cfg.steps, "lr": cfg.learning_rate,
    }
    save_qa_lm_adapter(lora_params, args.output_dir, lora_cfg,
                       base_dir=args.qa_lm, metrics=metrics)
    print(json.dumps({
        "causal_accuracy": {"base": base_causal["accuracy"],
                            "lora": lora_causal["accuracy"]},
        "base_family_accuracy": {"base": base_mix["accuracy"],
                                 "lora": lora_mix["accuracy"]},
        "adapter": args.output_dir,
    }, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
