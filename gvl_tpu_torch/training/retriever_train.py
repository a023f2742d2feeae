"""The self-trained retrieval text embedder and its trainer (counterpart of
:mod:`gvl_tpu.training.retriever_train`).

A byte-level :class:`~gvl_tpu_torch.models.siglip.SigLIPTextTower` (4
layers, hidden 256, 64 positions in ``outputs/retriever``) embeds timeline
event descriptions and queries; its attention goes through the flash
kernel.  :func:`train_retriever` trains it contrastively (a symmetric
InfoNCE at temperature 0.07) on (query, event-description) pairs drawn
from the paraphrase vocabulary below, with batch-unique targets; the same
seed draws the same pairs as the JAX package.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from gvl_tpu_torch import resolve_device
from gvl_tpu_torch.models.convert import siglip_text_params_from_jax
from gvl_tpu_torch.models.siglip import SigLIPTextConfig, SigLIPTextTower
from gvl_tpu_torch.nn.layers import load_module
from gvl_tpu_torch.utils.checkpoints import load_flat_npz

logger = logging.getLogger(__name__)


# the trained synonym map (the JAX module's ``ENTITY_SYNONYMS``): the open-vocab
# lexicon resolver's canonical concepts and their pools
ENTITY_SYNONYMS: dict[str, tuple[str, ...]] = {
    "player": ("hero", "protagonist", "main character", "avatar",
               "the character you control"),
    "enemy": ("foe", "villain", "monster", "opponent", "hostile"),
    "boss": ("boss monster", "final boss", "big bad", "miniboss"),
    "item": ("pickup", "loot", "collectible", "object", "power-up"),
}


HUD_SYNONYMS: dict[str, tuple[str, ...]] = {
    "HP": ("health", "hit points", "life"),
    "MP": ("mana", "magic points", "energy"),
    "SCORE": ("points", "score counter"),
    "GOLD": ("money", "coins", "currency"),
    "AMMO": ("ammunition", "bullets", "rounds"),
    "LV": ("level", "character level", "rank"),
}
AUDIO_SYNONYMS: dict[str, tuple[str, ...]] = {
    "impact sound": ("hit", "crash", "bang", "thud"),
    "background music": ("soundtrack", "music", "song", "bgm"),
    "UI chime": ("notification sound", "menu beep", "interface chime"),
    "ambient noise": ("background sound", "room tone", "ambience"),
    "voice chatter": ("talking", "voices", "dialogue", "speech"),
}
MOTIONS = ("moving up", "moving down", "moving left", "moving right",
           "moving up-right", "moving up-left", "moving down-right",
           "moving down-left")
MOTION_SYNONYMS: dict[str, tuple[str, ...]] = {
    "moving up": ("heading upward", "going up", "ascending"),
    "moving down": ("heading downward", "going down", "descending"),
    "moving left": ("heading left", "going left", "westward"),
    "moving right": ("heading right", "going right", "eastward"),
    "moving up-right": ("heading up and right", "going northeast"),
    "moving up-left": ("heading up and left", "going northwest"),
    "moving down-right": ("heading down and right", "going southeast"),
    "moving down-left": ("heading down and left", "going southwest"),
}
SPEECH_LINES = (
    "follow me to the gate", "enemy ahead take cover",
    "press the button now", "we need more supplies",
    "the bridge is out", "meet me at the tower",
    "watch out for the trap", "grab the key and run",
    "the door is locked", "reinforcements are coming",
    "head for the exit", "light the torch first",
    "save your ammo", "check the map again",
    "the boss is weak to fire", "use the potion now",
    "climb the ladder quickly", "wait for my signal",
    "they went through the tunnel", "defend the base",
)

_DETECT_TEMPLATES = (
    "when does the {e} appear", "when is the {e} first seen",
    "where is the {e}", "show me the {e}", "is there a {e} visible",
    "find the {e} on screen",
)
_MOTION_TEMPLATES = (
    "which way does the {e} go", "where is the {e} {m}",
    "is the {e} {m}", "track the {e} while it is {m}",
)
_OCR_TEMPLATES = (
    "what is the {w} value", "how much {w} is left",
    "read the {w} counter", "what does the {w} display say",
)
_AUDIO_TEMPLATES = (
    "when does the {a} play", "identify the {a}",
    "is there a {a} in the audio", "what time is the {a}",
)
_SPEECH_TEMPLATES = (
    "who said {s}", "when did someone say {s}",
    "find the line about {s}",
)
_ATTACK_TEMPLATES = (
    "who attacks the {b}", "what happened to the {b}",
    "why did the {b} get destroyed", "when is the {b} hit",
)
_COPY_TEMPLATES = (
    "find the event about {w}", "when does {w} happen",
    "tell me about {w}", "what is {w}", "show the {w} line",
)

_SYLLABLES = ("ba", "be", "bo", "da", "de", "do", "ka", "ke", "ko",
              "la", "le", "lo", "ma", "me", "mo", "na", "ne", "no",
              "ra", "re", "ro", "sa", "se", "so", "ta", "te", "to",
              "va", "ve", "vo", "za", "ze", "zo", "chi", "sha", "ga")


def _random_word(rng: np.random.Generator) -> str:
    n = int(rng.integers(2, 5))
    return "".join(str(rng.choice(_SYLLABLES)) for _ in range(n))


def _syn(rng: np.random.Generator, word: str, table: dict, paraphrase: bool) -> str:
    """The literal word (lexical regime) or a trained synonym."""
    if paraphrase:
        opts = table[word]
        return str(opts[int(rng.integers(0, len(opts)))])
    return word.lower()


def make_pair(rng: np.random.Generator, paraphrase_prob: float = 0.5) -> tuple[str, str, str]:
    """One (query, event-description, uniqueness-key) pair.

    The key dedupes confusable targets within a batch so in-batch InfoNCE
    negatives are true negatives.  Family 6 ("copy") pairs never-repeating
    random words with queries quoting them verbatim: generic byte-level
    lexical matching."""
    fam = int(rng.integers(0, 7))
    para = bool(rng.random() < paraphrase_prob)
    ents = list(ENTITY_SYNONYMS)
    if fam == 0:  # detection
        e = str(rng.choice(ents))
        q = str(rng.choice(_DETECT_TEMPLATES)).format(e=_syn(rng, e, ENTITY_SYNONYMS, para))
        return q, f"{e} detected", f"det:{e}"
    if fam == 1:  # motion (the trained clip-encoder's event format)
        e = str(rng.choice(ents))
        m = str(rng.choice(MOTIONS))
        q = str(rng.choice(_MOTION_TEMPLATES)).format(
            e=_syn(rng, e, ENTITY_SYNONYMS, para), m=_syn(rng, m, MOTION_SYNONYMS, para))
        return q, f"{e} {m}", f"mot:{e}"
    if fam == 2:  # HUD text (OCR)
        w = str(rng.choice(list(HUD_SYNONYMS)))
        val = (f"{rng.integers(1, 999)}/{rng.integers(1, 999)}"
               if rng.random() < 0.5 else f"{rng.integers(0, 9999)}")
        q = str(rng.choice(_OCR_TEMPLATES)).format(w=_syn(rng, w, HUD_SYNONYMS, para))
        return q, f"{w} {val}", f"ocr:{w}"
    if fam == 3:  # audio event
        a = str(rng.choice(list(AUDIO_SYNONYMS)))
        q = str(rng.choice(_AUDIO_TEMPLATES)).format(a=_syn(rng, a, AUDIO_SYNONYMS, para))
        return q, a, f"aud:{a}"
    if fam == 4:  # speech
        s = str(rng.choice(SPEECH_LINES))
        frag = " ".join(s.split()[-2:])  # quote the tail fragment
        q = str(rng.choice(_SPEECH_TEMPLATES)).format(s=frag)
        return q, s, f"sp:{s}"
    if fam == 5:  # attack / causal
        a, b = rng.choice(ents, 2, replace=False)
        q = str(rng.choice(_ATTACK_TEMPLATES)).format(b=_syn(rng, str(b), ENTITY_SYNONYMS, para))
        return q, f"(Event: {a} attacks {b})", f"atk:{b}"
    # copy: verbatim lexical matching on never-repeating random words
    words = [_random_word(rng) for _ in range(int(rng.integers(2, 5)))]
    desc = " ".join(words)
    pick = rng.choice(words, size=min(len(words), int(rng.integers(1, 3))), replace=False)
    q = str(rng.choice(_COPY_TEMPLATES)).format(w=" ".join(pick))
    return q, desc, f"cp:{desc}"


def make_batch(rng: np.random.Generator, n: int,
               paraphrase_prob: float = 0.5) -> tuple[list[str], list[str]]:
    """n pairs with batch-unique target keys (true in-batch negatives)."""
    queries, descs, seen = [], [], set()
    attempts = 0
    while len(queries) < n and attempts < n * 30:
        attempts += 1
        q, d, key = make_pair(rng, paraphrase_prob)
        if key in seen:
            continue
        seen.add(key)
        queries.append(q)
        descs.append(d)
    return queries, descs


def byte_tokenize(texts: Sequence[str], max_position: int = 32) -> np.ndarray:
    """Lowercased UTF-8 bytes, 0-padded on the LEFT to ``max_position``
    (``gvl_tpu.training.siglip_train.byte_tokenize``): the pooled output is
    taken at the last position, so text is right-aligned."""
    out = np.zeros((len(texts), max_position), np.int32)
    for i, text in enumerate(texts):
        ids = list(text.lower().encode("utf-8"))[: max_position]
        out[i, max_position - len(ids):] = ids
    return out


def tokenize(texts: Sequence[str], max_position: int = 64) -> np.ndarray:
    return byte_tokenize(texts, max_position)


def retriever_text_config(**kw) -> SigLIPTextConfig:
    base = dict(hidden_size=256, intermediate_size=1024, num_layers=4,
                num_heads=4, vocab_size=256, max_position=64,
                projection_size=256)
    base.update(kw)
    return SigLIPTextConfig(**base)


@dataclass
class RetrieverTrainConfig:
    steps: int = 3000
    batch_size: int = 36  # ≤ max distinct target keys (43)
    learning_rate: float = 3e-4
    weight_decay: float = 1e-4
    temperature: float = 0.07
    seed: int = 0
    log_every: int = 200
    paraphrase_prob: float = 0.5
    model: object = field(default_factory=retriever_text_config)


def _unit(z: torch.Tensor) -> torch.Tensor:
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)


def retriever_loss(tower: SigLIPTextTower, q_ids: torch.Tensor, d_ids: torch.Tensor,
                   temperature: float) -> torch.Tensor:
    """Symmetric InfoNCE (query → description and back) of one batch."""
    zq, zd = _unit(tower(q_ids)["pooled"]), _unit(tower(d_ids)["pooled"])
    logits = (zq @ zd.T) * (1.0 / temperature)
    labels = torch.arange(logits.shape[0], device=logits.device)
    ce = torch.nn.functional.cross_entropy
    return 0.5 * (ce(logits, labels) + ce(logits.T, labels))


def retriever_state(params: Optional[dict], model_cfg: SigLIPTextConfig, seed: int) -> dict:
    """The tower's weights a run starts from: ``params`` (a state dict or
    the JAX tree) or, without it, drawn from ``seed`` by Flax's laws."""
    from gvl_tpu_torch.training import init_laws

    convert = lambda tree: siglip_text_params_from_jax(tree, model_cfg.num_layers)
    if params is not None:
        return init_laws.as_state(params, convert)
    return init_laws.init_params(convert, init_laws.siglip_text_layout(model_cfg), seed)


def train_retriever(cfg: Optional[RetrieverTrainConfig] = None,
                    init_params: Optional[dict] = None, device="cuda",
                    on_step=None) -> dict[str, torch.Tensor]:
    """Train the text tower and return its f32 state dict (JAX's
    ``train_retriever``; ``on_step(i, loss)`` sees each step's loss on the
    device).  AdamW over a cosine schedule, a fresh batch every step."""
    from gvl_tpu_torch.training import init_laws, optim

    cfg = cfg or RetrieverTrainConfig()
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    with torch.device("meta"):
        tower = SigLIPTextTower(cfg.model)
    tower = init_laws.trainable(tower, retriever_state(init_params, cfg.model, cfg.seed), dev)
    logger.info("retriever params: %.2fM", sum(p.numel() for p in tower.parameters()) / 1e6)
    opt = optim.AdamW(tower.parameters(), optim.cosine_decay_schedule(
        cfg.learning_rate, cfg.steps), clip=None, weight_decay=cfg.weight_decay)
    for i in range(cfg.steps):
        queries, descs = make_batch(rng, cfg.batch_size, cfg.paraphrase_prob)
        q_ids, d_ids = (torch.from_numpy(tokenize(t, cfg.model.max_position)).to(dev)
                        for t in (queries, descs))
        loss = optim.train_step(tower, opt, lambda m: retriever_loss(
            m, q_ids, d_ids, cfg.temperature))
        if on_step is not None:
            on_step(i, loss)
        if cfg.log_every and (i % cfg.log_every == 0 or i == cfg.steps - 1):
            logger.info("retriever step %d loss %.4f", i, float(loss))
    return init_laws.state_of(tower)


# ------------------------------------------------------------------
# Evaluation: retrieval over held-out timelines vs the hashing baseline
# ------------------------------------------------------------------

def _eval_timeline(rng: np.random.Generator,
                   n_events: int = 12) -> tuple[list[str], int, str, str]:
    """(descriptions, target index, paraphrase query, lexical query)."""
    descs, keys = [], set()
    pairs = []
    while len(descs) < n_events:
        q_par, d, key = make_pair(rng, paraphrase_prob=1.0)
        if key in keys:
            continue
        keys.add(key)
        if key.startswith(("cp:", "sp:")):
            # copy/speech queries quote the description verbatim
            q_lex = q_par
        else:
            # a lexical twin of the same target key
            rng2 = np.random.default_rng(int(rng.integers(0, 2 ** 31)))
            while True:
                q_lex, _d2, key2 = make_pair(rng2, paraphrase_prob=0.0)
                if key2 == key:
                    break
        descs.append(d)
        pairs.append((q_par, q_lex))
    t = int(rng.integers(0, n_events))
    return descs, t, pairs[t][0], pairs[t][1]


def evaluate_retriever(embedder, n_timelines: int = 50, n_events: int = 12,
                       seed: int = 1234) -> dict:
    """Top-1/top-5 retrieval per query regime for any TextEmbedder (the
    trained tower or the hashing baseline, same protocol)."""
    rng = np.random.default_rng(seed)
    hits = {"paraphrase_top1": [], "paraphrase_top5": [],
            "lexical_top1": [], "lexical_top5": []}
    for _ in range(n_timelines):
        descs, t, q_par, q_lex = _eval_timeline(rng, n_events)
        z_d = embedder.encode(descs)
        z_d = z_d / np.maximum(np.linalg.norm(z_d, axis=-1, keepdims=True), 1e-12)
        for regime, q in (("paraphrase", q_par), ("lexical", q_lex)):
            z_q = embedder.encode([q])[0]
            z_q = z_q / max(float(np.linalg.norm(z_q)), 1e-12)
            order = np.argsort(-(z_d @ z_q))
            hits[f"{regime}_top1"].append(int(order[0] == t))
            hits[f"{regime}_top5"].append(int(t in order[:5]))
    out = {k: float(np.mean(v)) for k, v in hits.items()}
    out["n"] = n_timelines
    return out


def save_retriever(state: dict, out_dir, model_cfg: Optional[SigLIPTextConfig] = None,
                   metrics: Optional[dict] = None) -> None:
    """``params.npz`` (the JAX tree's flat npz) of the tower's state dict
    and ``retriever_config.json``, as JAX writes them."""
    from dataclasses import asdict

    from gvl_tpu_torch.models.convert import tree_from_state
    from gvl_tpu_torch.training import init_laws
    from gvl_tpu_torch.utils.checkpoints import save_flat_npz

    model_cfg = model_cfg or retriever_text_config()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_flat_npz(tree_from_state(lambda t: siglip_text_params_from_jax(t, model_cfg.num_layers),
                                  init_laws.shapes(init_laws.siglip_text_layout(model_cfg)),
                                  state), out / "params.npz")
    meta = {"model": asdict(model_cfg)}
    if metrics:
        meta["metrics"] = metrics
    (out / "retriever_config.json").write_text(json.dumps(meta, indent=2))


def load_retriever(ckpt_dir) -> tuple[SigLIPTextConfig, dict]:
    """(config, JAX parameter tree as numpy) of a trained retriever dir."""
    ckpt = Path(ckpt_dir)
    raw = json.loads((ckpt / "retriever_config.json").read_text())
    cfg = SigLIPTextConfig(**{
        k: v for k, v in raw["model"].items()
        if k in SigLIPTextConfig.__dataclass_fields__})
    return cfg, load_flat_npz(ckpt / "params.npz")


def is_trained_retriever_checkpoint(path) -> bool:
    return bool(path) and (Path(path) / "retriever_config.json").exists()


class TrainedTextEmbedder:
    """TextEmbedder protocol over the trained tower: L2-normalised pooled
    outputs, f32 numpy ``[N, projection_size]``."""

    def __init__(self, model_cfg: SigLIPTextConfig, params: dict,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.config = model_cfg
        self.dim = model_cfg.projection_size
        with torch.device("meta"):
            tower = SigLIPTextTower(model_cfg)
        state = params if "token_embed.weight" in params else \
            siglip_text_params_from_jax(params, model_cfg.num_layers)
        self.tower = load_module(tower, state, self.device)

    @torch.inference_mode()
    def embed_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """Token ids ``[N, T]`` on the tower's device → unit embeddings."""
        z = self.tower(ids)["pooled"]
        return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        if not len(texts):
            return np.zeros((0, self.dim), np.float32)
        ids = torch.from_numpy(tokenize(list(texts), self.config.max_position))
        return self.embed_ids(ids.to(self.device)).float().cpu().numpy()

    @classmethod
    def from_dir(cls, ckpt_dir, device: str | torch.device = "cuda") -> "TrainedTextEmbedder":
        cfg, params = load_retriever(ckpt_dir)
        return cls(cfg, params, device=device)
