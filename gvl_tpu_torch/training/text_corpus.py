"""Procedural gameplay-commentary corpus for text-tower pretraining (the
port's copy of :mod:`gvl_tpu.training.text_corpus`, numpy only).

Templated gameplay sentences in which synonym families share sentence
contexts ("the villain attacks the hero" / "the enemy attacks the hero"),
used by :func:`gvl_tpu_torch.training.siglip_train.pretrain_text_tower` to
pretrain the byte text tower with a word↔context contrastive objective
(the distributional hypothesis, word2vec-style).  The open-vocabulary
probe words ("protagonist", "villain", "foe", "power-up", "giant") occur in
this corpus but are never paired with an image in training.

Supervision: a (context-with-blank, word) pair is positive iff the target
WORD is identical; synonyms converge only because they fill the same
blanks.  The same seed draws the same words and contexts as the JAX
package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# ------------------------------------------------------------------
# Vocabulary: synonym families share sentence slots.  Kept small and
# gaming-flavored; every word fits the 32-byte text canvas.
# ------------------------------------------------------------------

# slot: PLAYER-like subject (controlled character)
PLAYER_WORDS = ("player", "hero", "protagonist", "avatar", "adventurer",
                "main character", "character")
# slot: ENEMY-like subject (hostile, ordinary size)
ENEMY_WORDS = ("enemy", "monster", "villain", "foe", "attacker",
               "opponent", "adversary", "baddie", "creature")
# slot: BOSS-like subject (hostile, large/final)
BOSS_WORDS = ("boss", "big bad", "giant", "behemoth", "titan",
              "huge monster", "final boss", "elite enemy")
# slot: ITEM-like object (collectible)
ITEM_WORDS = ("item", "pickup", "power-up", "loot", "collectible",
              "treasure", "bonus", "reward", "coin")
# slot: size adjective for hostile subjects (binds "giant" to bigness)
BIG_ADJ = ("giant", "huge", "massive", "towering", "enormous", "large")
SMALL_ADJ = ("small", "tiny", "little", "weak")
# background / UI words keep the negative classes populated
SCENE_WORDS = ("background", "terrain", "scenery", "ground", "floor",
               "level", "arena", "stage")
UI_WORDS = ("health bar", "status bar", "hud", "menu", "interface",
            "score counter", "minimap")

FAMILIES: dict[str, tuple[str, ...]] = {
    "player": PLAYER_WORDS,
    "enemy": ENEMY_WORDS,
    "boss": BOSS_WORDS,
    "item": ITEM_WORDS,
    "scene": SCENE_WORDS,
    "ui": UI_WORDS,
}

# templates per slot kind; "{}" is the blank the target word fills.
# ≤ 32 UTF-8 bytes with the longest vocabulary entry.
_HOSTILE_TEMPLATES = (
    "the {} attacks",
    "a {} appears",
    "fight the {}",
    "the {} blocks the path",
    "dodge the {}",
    "the {} takes damage",
    "defeat the {}",
    "the {} charges at you",
)
# exclusive boss contexts (size/finality) — enemies also fill the shared
# hostile contexts above, bosses fill BOTH, so boss-words sit near
# enemy-words but keep a distinct direction
_BOSS_TEMPLATES = (
    "the {} guards the exit",
    "a {} ends the level",
    "the {} has a huge health bar",
    "the final fight: a {}",
)
_PLAYER_TEMPLATES = (
    "the {} jumps",
    "you control the {}",
    "the {} levels up",
    "the {} takes the hit",
    "move the {} left",
    "the {} wins the round",
)
_ITEM_TEMPLATES = (
    "grab the {}",
    "a {} drops",
    "collect the {}",
    "pick up the {}",
    "the {} restores health",
    "a shiny {} appears",
)
_SCENE_TEMPLATES = (
    "the {} scrolls by",
    "empty {}",
    "the {} is dark",
    "walk across the {}",
)
_UI_TEMPLATES = (
    "the {} fills up",
    "check the {}",
    "the {} flashes",
    "the {} shows the score",
)

TEMPLATES: dict[str, tuple[str, ...]] = {
    "player": _PLAYER_TEMPLATES,
    "enemy": _HOSTILE_TEMPLATES,
    "boss": _HOSTILE_TEMPLATES + _BOSS_TEMPLATES,
    "item": _ITEM_TEMPLATES,
    "scene": _SCENE_TEMPLATES,
    "ui": _UI_TEMPLATES,
}


def sample_word_context(rng: np.random.Generator,
                        family: Optional[str] = None,
                        max_bytes: int = 32,
                        blank_prob: float = 0.8) -> tuple[str, str, str]:
    """(word, context_sentence, family).

    With probability ``blank_prob`` the context carries a ``_`` where
    the word goes (CBOW-style): synonyms then share byte-identical
    contexts, so their embeddings are pulled toward identical targets —
    the strongest purely-distributional convergence signal.  The rest
    keep the word inline (plain commentary, like a word2vec window
    containing the target).  Hostile subjects sometimes carry a size
    adjective: big ones for boss words, small ones for enemy words —
    scene statistics ("giant" co-occurs with boss-scale subjects), not
    a label.
    """
    fam = family or str(rng.choice(list(FAMILIES)))
    word = str(rng.choice(FAMILIES[fam]))
    surface = word
    if fam == "boss" and rng.random() < 0.3:
        surface = f"{rng.choice(BIG_ADJ)} {word}"
    elif fam == "enemy" and rng.random() < 0.15:
        surface = f"{rng.choice(SMALL_ADJ)} {word}"
    if rng.random() < blank_prob:
        surface = "_"
    for _ in range(8):
        sent = str(rng.choice(TEMPLATES[fam])).format(surface)
        if len(sent.encode("utf-8")) <= max_bytes:
            return word, sent, fam
    return word, surface, fam


def word_context_batch(rng: np.random.Generator, n: int,
                       max_position: int = 32
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(word_ids [n, P], context_ids [n, P], word_keys [n]).

    ``word_keys`` identifies the target WORD (not the family): pairs
    sharing a word are multi-positives, everything else is negative —
    synonym-family membership never reaches the labels.
    """
    from gvl_tpu_torch.training.retriever_train import byte_tokenize

    words, contexts, keys = [], [], []
    vocab_index: dict[str, int] = {}
    for _ in range(n):
        word, sent, _ = sample_word_context(rng)
        words.append(word)
        contexts.append(sent)
        keys.append(vocab_index.setdefault(word, len(vocab_index)))
    return (byte_tokenize(words, max_position),
            byte_tokenize(contexts, max_position),
            np.asarray(keys, np.int32))
