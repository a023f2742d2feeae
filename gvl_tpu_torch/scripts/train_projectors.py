"""Train the ProjectorBank against a frozen LLM (generative alignment):
the port's copy of ``scripts/train_projectors.py``, on ``--device``.

    python -m gvl_tpu_torch.scripts.train_projectors --features-dir data/features [--device cpu]

Reads the ``*_embeddings.npz`` + ``*_features.json`` artifacts produced by
``extract_features``; writes the reference-layout ``projector_weights.pt``
(best epoch loss).  ``--llm-checkpoint`` names a local HF Qwen3 directory
(read with ``transformers``); without it the cosine-contrastive objective
against the hashing text space runs, ``--objective norm`` for calibration
only.  ``--device`` defaults to ``cuda`` and raises without a card unless
``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import logging

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.training import (
    MultimodalProjectorDataset,
    ProjectorTrainer,
    ProjectorTrainingConfig,
    evaluate_retrieval,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--features-dir", default="data/features")
    parser.add_argument("--output", default="outputs/projector_weights.pt")
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--llm-checkpoint", default=None,
                        help="frozen LLM for generative alignment; "
                             "without it the cosine-contrastive "
                             "objective against the hashing text space "
                             "runs, --objective norm for calibration only")
    parser.add_argument("--objective", default="cosine",
                        choices=["cosine", "norm"],
                        help="no-LLM fallback objective")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    device = resolve_device(args.device)

    dataset = MultimodalProjectorDataset(args.features_dir)
    if not len(dataset):
        print(f"no training samples under {args.features_dir} — run "
              f"extract_features first")
        return 1

    llm = None
    if args.llm_checkpoint:
        from transformers import AutoTokenizer

        from gvl_tpu_torch.models.qwen3 import load_hf_qwen3

        config, state = load_hf_qwen3(args.llm_checkpoint)
        tokenizer = AutoTokenizer.from_pretrained(args.llm_checkpoint)
        llm = (config, state, tokenizer.encode)

    # projector head input dims follow the data
    from gvl_tpu_torch.agent.config import ReasoningCoreConfig
    from gvl_tpu_torch.models.projector import MODALITY_DIMS

    train_cfg = ProjectorTrainingConfig(
        epochs=args.epochs, batch_size=args.batch_size,
        learning_rate=args.lr, output_path=args.output,
        objective=args.objective,
    )
    rc = ReasoningCoreConfig(llm_hidden_dim=train_cfg.llm_dim)
    for modality, dim in dataset.modality_dims().items():
        attr = MODALITY_DIMS.get(modality)
        if attr and getattr(rc, attr) != dim:
            logging.getLogger(__name__).info(
                "projector head '%s': input dim %d from data "
                "(config default %d)", modality, dim, getattr(rc, attr))
            setattr(rc, attr, dim)

    trainer = ProjectorTrainer(train_cfg, reasoning_config=rc, llm=llm, device=device)
    before = evaluate_retrieval(trainer.bank, dataset)
    print("retrieval before training:", before)
    result = trainer.train(dataset)
    after = evaluate_retrieval(trainer.bank, dataset)
    print("retrieval after training:", after)
    print(f"done: best_loss={result['best_loss']:.4f} -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
