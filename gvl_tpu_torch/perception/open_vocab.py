"""Open-vocabulary segmentation: segmenter proposals named in the
mini-SigLIP's image-text space (counterpart of
:mod:`gvl_tpu.perception.open_vocab`).

:class:`OpenVocabSamBackend` takes class-agnostic mask proposals (from the
trained promptable segmenter prompted with its training concepts, after
mask NMS), crops each onto the mini-SigLIP canvas and scores it against the
caller's text prompts, each embedded under a template ensemble; the
:class:`LexiconPromptResolver` first maps unseen phrasings onto the
trained concepts through the trained retriever's text space.  It follows
the segmenter backend protocol (``(frames, concepts, frame_indices) →
results[frame][concept]``), so the tracker stacks on it unchanged.  Both
towers and the segmenter run on ``device``, their attention through the
flash kernel.

The HF rung (SAM point-grid proposals scored by an HF SigLIP pair:
``from_checkpoints``, ``create_open_vocab_segmenter``) is not ported and
raises (ROADMAP A10).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.perception.segmenter import BoundingBox, SegmentationMask

logger = logging.getLogger(__name__)

# default ensemble for the self-trained composite (the JAX module's)
TRAINED_PROMPT_TEMPLATES = ("{}", "sprite of {}", "a {}", "the {}")


class LexiconPromptResolver:
    """Resolve caller prompts to trained canonical concepts through the
    retrieval text-embedding space: embed the prompt (and its content
    words), take the cosine against every canonical concept's synonym pool,
    and substitute the canonical name when confident and clear of the
    runner-up by ``margin``; otherwise the raw prompt passes through."""

    _STOPWORDS = frozenset(
        "a an the of in on at and or one some this that you can".split())

    def __init__(self, embedder, lexicon: dict, threshold: float = 0.62,
                 word_threshold: float = 0.80, margin: float = 0.12):
        texts: list[str] = []
        owners: list[str] = []
        for canon, pool in lexicon.items():
            for t in dict.fromkeys((canon, *pool)):
                texts.append(t)
                owners.append(canon)
        self._exact = {t.lower(): o for t, o in zip(texts, owners)}
        emb = np.array(embedder.encode(texts), np.float32)
        emb /= np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-9)
        self._emb = emb
        self._owners = owners
        self._canonical = set(lexicon)
        self._embedder = embedder
        self.threshold = threshold
        self.word_threshold = word_threshold
        self.margin = margin
        self._cache: dict[str, tuple[str, float]] = {}

    @classmethod
    def from_trained(cls, retriever_dir: str = "outputs/retriever",
                     lexicon: Optional[dict] = None,
                     device: str | torch.device = "cuda", **kw) -> "LexiconPromptResolver":
        from gvl_tpu_torch.training.retriever_train import (
            ENTITY_SYNONYMS,
            TrainedTextEmbedder,
        )

        return cls(TrainedTextEmbedder.from_dir(retriever_dir, device=device),
                   lexicon or dict(ENTITY_SYNONYMS), **kw)

    def resolve(self, prompt: str) -> str:
        """Canonical concept when confident, the raw prompt otherwise."""
        return self.resolve_scored(prompt)[0]

    def resolve_scored(self, prompt: str) -> tuple[str, float]:
        """(resolved, confidence): the winning cosine, 1.0 for canonical or
        verbatim pool hits, 0.0 for passthrough."""
        if prompt in self._canonical:
            return prompt, 1.0
        if prompt not in self._cache:
            self._cache[prompt] = self._resolve_uncached(prompt)
        return self._cache[prompt]

    def resolve_set(self, prompts: Sequence[str]) -> list[str]:
        """Resolve a SET of prompts injectively: when two prompts resolve to
        the same canonical only the most confident keeps it and the rest
        pass through raw."""
        scored = [self.resolve_scored(p) for p in prompts]
        winner: dict[str, int] = {}
        for i, ((res, conf), raw) in enumerate(zip(scored, prompts)):
            if res == raw:
                continue
            if res in prompts:          # canonical asked for verbatim
                continue
            if res not in winner or conf > scored[winner[res]][1]:
                winner[res] = i
        return [res if (res == raw or winner.get(res) == i) else raw
                for i, ((res, _), raw) in enumerate(zip(scored, prompts))]

    def _resolve_uncached(self, prompt: str) -> tuple[str, float]:
        lowered = prompt.lower().strip()
        if lowered in self._exact:                 # verbatim pool entry
            return self._exact[lowered], 1.0
        words = [w for w in lowered.split()
                 if w not in self._STOPWORDS and len(w) >= 3]
        cands = list(dict.fromkeys([prompt, *words]))
        q = np.array(self._embedder.encode(cands), np.float32)
        q /= np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-9)
        sims = q @ self._emb.T                     # [cands, pool]
        # single words get the stricter threshold
        thresholds = [self.threshold] + [self.word_threshold] * len(words)
        per_concept: dict[str, float] = {}
        for i, thresh in enumerate(thresholds[: len(cands)]):
            for j, owner in enumerate(self._owners):
                s = float(sims[i, j])
                if s >= thresh:
                    per_concept[owner] = max(per_concept.get(owner, -1.0), s)
        if not per_concept:
            return prompt, 0.0
        ranked = sorted(per_concept.items(), key=lambda kv: -kv[1])
        best_c, best_s = ranked[0]
        # margin over the runner-up measured WITHOUT thresholds
        others = [float(sims[:, j].max())
                  for j, o in enumerate(self._owners) if o != best_c]
        if others and best_s - max(others) < self.margin:
            return prompt, 0.0
        return best_c, best_s


class OpenVocabSamBackend:
    """Mask proposals + SigLIP text scoring.

    ``propose_fn`` (frames → proposal masks ``[B, P, h, w]`` and scores
    ``[B, P]``) supplies the proposals; the SAM point-grid proposer the JAX
    class builds without one needs the HF SAM port (ROADMAP A10).
    ``vision_backend`` is a uint8-in, pooled-out backend
    (:class:`~gvl_tpu_torch.perception.semantic.TorchSigLIPBackend` with
    'cls' pooling); ``text_tower`` a text tower on the same device."""

    def __init__(self, sam_config, sam_params, vision_backend, text_tower, text_params,
                 tokenize, grid: int = 4, iou_threshold: float = 0.7,
                 score_threshold: float = 0.1, max_proposals: int = 16,
                 propose_fn=None, region_resolution: Optional[int] = None,
                 prompt_templates: Optional[Sequence[str]] = None,
                 prompt_resolver: Optional[LexiconPromptResolver] = None):
        from gvl_tpu_torch.perception.semantic import NaFlexConfig, RegionExtractor

        if propose_fn is None:
            raise NotImplementedError(
                "SAM point-grid proposals need the HF SAM ViT port, which is not "
                "ported yet (ROADMAP A10): pass propose_fn")
        self.sam_config = sam_config
        self.sam_params = sam_params
        self.vision_backend = vision_backend
        self.text_tower = text_tower
        self.text_params = text_params
        self._tokenize = tokenize
        self.grid = grid
        self.iou_threshold = iou_threshold
        self.score_threshold = score_threshold
        self.max_proposals = max_proposals
        # CLIP-style prompt ensembling: each caller prompt is embedded under
        # every template and the normalized embeddings averaged
        self.prompt_templates = tuple(prompt_templates) if prompt_templates else None
        self.prompt_resolver = prompt_resolver
        self._text_cache: dict[tuple[str, ...], np.ndarray] = {}
        self._naflex = NaFlexConfig()
        if region_resolution:
            self._naflex.region_resolution = region_resolution
        self._extractor = RegionExtractor(self._naflex)
        self._proposals = propose_fn

    @torch.inference_mode()
    def _embed_text(self, ids: np.ndarray) -> np.ndarray:
        device = next(self.text_tower.parameters()).device
        out = self.text_tower(torch.from_numpy(ids).to(device))["pooled"]
        out = out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-9)
        return out.float().cpu().numpy()

    # ------------------------------------------------------------ loading

    @classmethod
    def from_checkpoints(cls, sam_dir: str, siglip_vision_dir: str,
                         siglip_text_dir: Optional[str] = None, **kw) -> "OpenVocabSamBackend":
        """HF SAM + SigLIP checkpoint directories: not ported (ROADMAP A10)."""
        raise NotImplementedError(
            "open-vocab segmentation from HF SAM and SigLIP checkpoints is not "
            "ported yet (ROADMAP A10)")

    @classmethod
    def from_trained_checkpoints(cls, segmenter_checkpoint: str, minisiglip_dir: str,
                                 proposal_concepts: Optional[Sequence[str]] = None,
                                 retriever_dir: Optional[str] = "auto",
                                 device: str | torch.device = "cuda",
                                 **kw) -> "OpenVocabSamBackend":
        """The fully offline composite: proposals from the trained
        promptable segmenter prompted with its training concepts
        (class-agnostic after mask NMS), named against the CALLER's text
        prompts in the mini-SigLIP image-text space; the lexicon resolver
        rides the trained retriever beside the segmenter checkpoint when
        ``retriever_dir`` is "auto" and one is there (otherwise the raw
        prompts go to the tower, as in JAX)."""
        from gvl_tpu_torch.perception.segmenter import SAMConfig as SegSAMConfig
        from gvl_tpu_torch.perception.segmenter import create_sam_segmenter
        from gvl_tpu_torch.perception.semantic import NaFlexConfig, TorchSigLIPBackend
        from gvl_tpu_torch.training.siglip_train import byte_tokenize, load_minisiglip

        device = resolve_device(device)
        model, vision_cfg, text_cfg = load_minisiglip(minisiglip_dir, device)
        nc = NaFlexConfig(pool_strategy="cls")
        vision_backend = TorchSigLIPBackend(model.vision, nc.dtype, image_mean=nc.image_mean,
                                            image_std=nc.image_std, pool_strategy="cls")
        seg = create_sam_segmenter(SegSAMConfig(), use_model=True,
                                   checkpoint=segmenter_checkpoint, device=device)
        seg_backend = seg.backend
        if proposal_concepts is None:
            from gvl_tpu_torch.training.segmenter_train import CONCEPTS

            proposal_concepts = CONCEPTS
        proposal_concepts = list(proposal_concepts)

        def propose(frames):
            out, n_real = seg_backend.submit(frames, proposal_concepts)
            masks = out["mask"].cpu().numpy().astype(bool)[:n_real]
            scores = out["scores"].float().cpu().numpy()[:n_real]
            b, c, q = scores.shape
            return (masks.reshape(b, c * q, *masks.shape[3:]), scores.reshape(b, c * q))

        def tokenize(texts):
            return byte_tokenize(list(texts), text_cfg.max_position)

        kw.setdefault("prompt_templates", TRAINED_PROMPT_TEMPLATES)
        if retriever_dir == "auto":
            cand = Path(segmenter_checkpoint).resolve().parent / "retriever"
            retriever_dir = str(cand) if (cand / "retriever_config.json").exists() else None
        if retriever_dir and "prompt_resolver" not in kw:
            kw["prompt_resolver"] = LexiconPromptResolver.from_trained(retriever_dir,
                                                                       device=device)
        return cls(None, None, vision_backend, model.text, None, tokenize,
                   propose_fn=propose, region_resolution=vision_cfg.image_size, **kw)

    # ----------------------------------------------------------- internals

    def _concept_embeddings(self, concepts: Sequence[str]) -> np.ndarray:
        key = tuple(concepts)
        if key not in self._text_cache:
            if self.prompt_resolver is not None:
                # lexicon resolution before templating, injective over the
                # set (the cache stays keyed on the caller's raw prompts)
                concepts = self.prompt_resolver.resolve_set(list(concepts))
            if self.prompt_templates:
                texts = [t.format(c) for c in concepts for t in self.prompt_templates]
                emb = self._embed_text(np.asarray(self._tokenize(texts), np.int32))
                emb = emb.reshape(len(concepts), len(self.prompt_templates), -1).mean(1)
                emb /= np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-9)
                self._text_cache[key] = emb
            else:
                self._text_cache[key] = self._embed_text(
                    np.asarray(self._tokenize(list(concepts)), np.int32))
        return self._text_cache[key]

    def _nms(self, masks: np.ndarray, scores: np.ndarray):
        """Score-ordered mask NMS → kept indices."""
        order = np.argsort(-scores)
        kept: list[int] = []
        for idx in order:
            m = masks[idx]
            if not m.any():
                continue
            dup = any(
                (m & masks[j]).sum() / max((m | masks[j]).sum(), 1) > self.iou_threshold
                for j in kept
            )
            if not dup:
                kept.append(int(idx))
            if len(kept) >= self.max_proposals:
                break
        return kept

    # ------------------------------------------------------------ protocol

    def __call__(self, frames, concepts, frame_indices):
        from gvl_tpu_torch.runtime.native import resize_mask

        prop_masks, prop_iou = self._proposals(frames)
        prop_masks = np.asarray(prop_masks)     # [B, P, h', w'] bool
        prop_iou = np.asarray(prop_iou)         # [B, P]
        text_emb = self._concept_embeddings(concepts)   # [C, D]

        results = []
        for fi, frame in enumerate(frames):
            h, w = frame.shape[:2]
            kept = self._nms(prop_masks[fi], prop_iou[fi])
            regions, full_masks = [], []
            for j in kept:
                mask = resize_mask(prop_masks[fi, j], h, w)
                ys, xs = np.where(mask)
                if len(xs) == 0:
                    continue
                regions.append(frame[ys.min():ys.max() + 1, xs.min():xs.max() + 1])
                full_masks.append((mask, float(prop_iou[fi, j]),
                                   (float(xs.min()), float(ys.min()),
                                    float(xs.max()), float(ys.max()))))
            per_frame = [[] for _ in concepts]
            if regions:
                res = self._naflex.region_resolution
                prepared = [self._extractor.prepare(r, res)[0] for r in regions]
                n = len(prepared)
                # bucket-pad, as the JAX class does to compile once a bucket
                bucket = next((b for b in (1, 4, 8, self.max_proposals) if n <= b), n)
                prepared += [np.zeros_like(prepared[0])] * (bucket - n)
                _, pooled = self.vision_backend(np.stack(prepared))
                pooled = pooled[:n]
                emb = pooled / np.maximum(np.linalg.norm(pooled, axis=-1, keepdims=True), 1e-9)
                scores = emb @ text_emb.T               # [R, C]
                for r, (mask, _, bbox) in enumerate(full_masks):
                    ci = int(np.argmax(scores[r]))
                    if scores[r, ci] < self.score_threshold:
                        continue
                    per_frame[ci].append({"mask": SegmentationMask(
                        mask=mask, confidence=float(scores[r, ci]),
                        bbox=BoundingBox(*bbox), area_pixels=int(mask.sum()))})
            results.append(per_frame)
        return results


def create_open_vocab_segmenter(sam_dir: str, siglip_vision_dir: str,
                                siglip_text_dir: Optional[str] = None, config=None, **kw):
    """HF SAM + SigLIP composite: not ported (ROADMAP A10)."""
    raise NotImplementedError(
        "open-vocab segmentation from HF SAM and SigLIP checkpoints is not ported "
        "yet (ROADMAP A10)")


def create_trained_open_vocab_segmenter(segmenter_checkpoint: str, minisiglip_dir: str,
                                        config=None, device: str | torch.device = "cuda",
                                        **kw):
    """SAMConceptSegmenter (tracking included) over the self-trained
    composite."""
    from gvl_tpu_torch.perception.segmenter import SAMConceptSegmenter, SAMConfig

    backend = OpenVocabSamBackend.from_trained_checkpoints(
        segmenter_checkpoint, minisiglip_dir, device=device, **kw)
    return SAMConceptSegmenter(config or SAMConfig(), backend=backend)
