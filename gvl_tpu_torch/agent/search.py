"""Game-knowledge web search tool: lookup, caching, game auto-detection
(the port's copy of :mod:`gvl_tpu.agent.search`).

A DuckDuckGo search path with an HTML-scrape fallback, gaming-domain
boosting, a 24 h disk+memory cache, category helpers
(boss/character/item/...), an OpenAI-style tool definition, and
regex-based game detection from OCR/speech text.  All network access
degrades to empty results where there is no network; the cache layer is
exercised either way.  ``enable_network=False`` makes no network call.
"""

from __future__ import annotations

import hashlib
import html.parser
import json
import logging
import re
import time
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)


@dataclass
class SearchResult:
    title: str
    snippet: str
    url: str
    source_domain: str = ""
    relevance_score: float = 0.0

    def to_dict(self) -> dict:
        return {
            "title": self.title,
            "snippet": self.snippet,
            "url": self.url,
            "source_domain": self.source_domain,
            "relevance_score": self.relevance_score,
        }

    @classmethod
    def from_dict(cls, data: dict) -> "SearchResult":
        return cls(**data)


@dataclass
class GameContext:
    """What we believe about the game being played."""

    game_name: Optional[str] = None
    game_genre: Optional[str] = None
    detected_from: Optional[str] = None   # "ocr" | "speech" | "manual"
    confidence: float = 0.0
    detected_entities: list[str] = field(default_factory=list)


class SearchCache:
    """md5(query)-keyed JSON cache with TTL (default 24 h)."""

    def __init__(self, cache_dir: str | Path = "data/outputs/search_cache",
                 ttl_hours: float = 24.0):
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.ttl_sec = ttl_hours * 3600
        self._memory: dict[str, tuple[float, list[SearchResult]]] = {}

    def _key(self, query: str) -> str:
        return hashlib.md5(query.lower().strip().encode()).hexdigest()

    def get(self, query: str) -> Optional[list[SearchResult]]:
        key = self._key(query)
        hit = self._memory.get(key)
        if hit and time.time() - hit[0] < self.ttl_sec:
            return hit[1]
        path = self.cache_dir / f"{key}.json"
        if path.exists():
            try:
                doc = json.loads(path.read_text())
                if time.time() - doc["cached_at"] < self.ttl_sec:
                    results = [SearchResult.from_dict(r) for r in doc["results"]]
                    self._memory[key] = (doc["cached_at"], results)
                    return results
                path.unlink()
            except Exception:
                path.unlink(missing_ok=True)
        return None

    def put(self, query: str, results: list[SearchResult]) -> None:
        key = self._key(query)
        now = time.time()
        self._memory[key] = (now, results)
        (self.cache_dir / f"{key}.json").write_text(json.dumps({
            "query": query,
            "cached_at": now,
            "results": [r.to_dict() for r in results],
        }))

    def clear(self) -> None:
        self._memory.clear()
        for f in self.cache_dir.glob("*.json"):
            f.unlink()


class _ResultHTMLParser(html.parser.HTMLParser):
    """Minimal parser for the DuckDuckGo lite HTML results page."""

    def __init__(self):
        super().__init__()
        self.results: list[tuple[str, str]] = []
        self._in_link = False
        self._href = ""
        self._text: list[str] = []

    def handle_starttag(self, tag, attrs):
        attrs = dict(attrs)
        if tag == "a" and "result" in attrs.get("class", ""):
            self._in_link = True
            self._href = attrs.get("href", "")
            self._text = []

    def handle_endtag(self, tag):
        if tag == "a" and self._in_link:
            self._in_link = False
            self.results.append((" ".join(self._text).strip(), self._href))

    def handle_data(self, data):
        if self._in_link:
            self._text.append(data.strip())


class GameKnowledgeSearcher:
    """Web lookup for game knowledge with domain boosting and caching."""

    GAMING_DOMAINS = (
        "fandom.com", "fextralife.com", "ign.com", "gamefaqs.gamespot.com",
        "gamespot.com", "polygon.com", "pcgamer.com", "eurogamer.net",
        "kotaku.com", "wiki.gg", "gamerant.com", "thegamer.com",
        "steamcommunity.com", "reddit.com",
    )

    def __init__(
        self,
        cache: Optional[SearchCache] = None,
        max_results: int = 5,
        enable_network: bool = True,
        timeout: float = 8.0,
    ):
        self.cache = cache or SearchCache()
        self.max_results = max_results
        self.enable_network = enable_network
        self.timeout = timeout
        self.game_context = GameContext()

    # --------------------------------------------------------------- search

    def set_game_context(self, game_name: str, genre: Optional[str] = None,
                         detected_from: str = "manual") -> None:
        self.game_context = GameContext(
            game_name=game_name, game_genre=genre,
            detected_from=detected_from, confidence=1.0,
        )

    def _augment_query(self, query: str, category: str) -> str:
        modifiers = {
            "wiki": "wiki",
            "guide": "guide walkthrough",
            "lore": "lore story explained",
            "boss": "boss guide weakness strategy",
            "character": "character abilities stats",
            "item": "item location effect",
            "mechanic": "game mechanic explained",
        }
        parts = [query]
        if self.game_context.game_name and (
            self.game_context.game_name.lower() not in query.lower()
        ):
            parts.insert(0, self.game_context.game_name)
        if category in modifiers:
            parts.append(modifiers[category])
        return " ".join(parts)

    def search(self, query: str, category: str = "general") -> list[SearchResult]:
        full_query = self._augment_query(query, category)
        cached = self.cache.get(full_query)
        if cached is not None:
            return cached
        results = self._search_duckduckgo(full_query)
        if not results:
            results = self._search_html_fallback(full_query)
        results = self._boost_gaming_domains(results)[: self.max_results]
        self.cache.put(full_query, results)
        return results

    def _search_duckduckgo(self, query: str) -> list[SearchResult]:
        if not self.enable_network:
            return []
        try:
            from duckduckgo_search import DDGS

            results = []
            with DDGS() as ddgs:
                for r in ddgs.text(query, max_results=self.max_results * 2):
                    url = r.get("href", "")
                    results.append(SearchResult(
                        title=r.get("title", ""),
                        snippet=r.get("body", "")[:300],
                        url=url,
                        source_domain=urllib.parse.urlparse(url).netloc,
                    ))
            return results
        except Exception as exc:
            logger.debug("duckduckgo_search unavailable: %s", exc)
            return []

    def _search_html_fallback(self, query: str) -> list[SearchResult]:
        if not self.enable_network:
            return []
        try:
            url = "https://html.duckduckgo.com/html/?q=" + urllib.parse.quote(query)
            req = urllib.request.Request(url, headers={"User-Agent": "Mozilla/5.0"})
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                page = resp.read().decode("utf-8", "ignore")
            parser = _ResultHTMLParser()
            parser.feed(page)
            results = []
            for text, href in parser.results[: self.max_results * 2]:
                if not text:
                    continue
                results.append(SearchResult(
                    title=text[:120], snippet=text[:300], url=href,
                    source_domain=urllib.parse.urlparse(href).netloc,
                ))
            return results
        except Exception as exc:
            logger.debug("html search fallback failed: %s", exc)
            return []

    def _boost_gaming_domains(
        self, results: list[SearchResult]
    ) -> list[SearchResult]:
        for i, result in enumerate(results):
            score = 1.0 - i * 0.05  # preserve engine order as the base
            if any(d in result.source_domain for d in self.GAMING_DOMAINS):
                score += 0.5
            result.relevance_score = score
        return sorted(results, key=lambda r: r.relevance_score, reverse=True)

    # ----------------------------------------------------- category helpers

    def search_wiki(self, query: str) -> list[SearchResult]:
        return self.search(query, "wiki")

    def search_guide(self, query: str) -> list[SearchResult]:
        return self.search(query, "guide")

    def search_lore(self, query: str) -> list[SearchResult]:
        return self.search(query, "lore")

    def search_boss(self, boss_name: str) -> list[SearchResult]:
        return self.search(boss_name, "boss")

    def search_character(self, name: str) -> list[SearchResult]:
        return self.search(name, "character")

    def search_item(self, item_name: str) -> list[SearchResult]:
        return self.search(item_name, "item")

    def search_mechanic(self, mechanic: str) -> list[SearchResult]:
        return self.search(mechanic, "mechanic")

    # ------------------------------------------------------------- tool API

    @staticmethod
    def get_tool_definition() -> dict:
        """OpenAI-style function definition for LLM tool calling."""
        return {
            "type": "function",
            "function": {
                "name": "search_web",
                "description": (
                    "Search the web for game-related information: boss "
                    "strategies and weaknesses, game mechanics, lore, "
                    "character abilities, item locations and effects."
                ),
                "parameters": {
                    "type": "object",
                    "properties": {
                        "query": {
                            "type": "string",
                            "description": "The search query.",
                        },
                    },
                    "required": ["query"],
                },
            },
        }

    def execute_tool_call(self, query: str, category: str = "general") -> str:
        """Run a search and format results for the follow-up prompt."""
        results = self.search(query, category)
        if not results:
            return "[No search results found]"
        lines = ["## Web Search Results", ""]
        for result in results:
            lines.append(f"- **{result.title}**: {result.snippet}")
        return "\n".join(lines)


class GameDetector:
    """Regex-based game identification from OCR / speech text."""

    GAME_PATTERNS: dict[str, tuple[str, str]] = {
        # pattern -> (canonical name, genre)
        r"\belden ring\b": ("Elden Ring", "Action RPG"),
        r"\bdark souls\b": ("Dark Souls", "Action RPG"),
        r"\bsekiro\b": ("Sekiro: Shadows Die Twice", "Action-Adventure"),
        r"\bbloodborne\b": ("Bloodborne", "Action RPG"),
        r"\bminecraft\b": ("Minecraft", "Sandbox"),
        r"\bfortnite\b": ("Fortnite", "Battle Royale"),
        r"\bvalorant\b": ("Valorant", "Tactical FPS"),
        r"\bleague of legends\b": ("League of Legends", "MOBA"),
        r"\bdota\s*2\b": ("Dota 2", "MOBA"),
        r"\boverwatch\b": ("Overwatch", "Hero Shooter"),
        r"\bcounter.?strike\b|\bcs:?go\b|\bcs2\b": ("Counter-Strike", "Tactical FPS"),
        r"\bapex legends\b": ("Apex Legends", "Battle Royale"),
        r"\bcall of duty\b|\bwarzone\b": ("Call of Duty", "FPS"),
        r"\bgenshin impact\b": ("Genshin Impact", "Action RPG"),
        r"\bzelda\b|\btears of the kingdom\b|\bbreath of the wild\b":
            ("The Legend of Zelda", "Action-Adventure"),
        r"\bmario kart\b": ("Mario Kart", "Racing"),
        r"\bsuper mario\b": ("Super Mario", "Platformer"),
        r"\bpokemon\b|\bpokémon\b": ("Pokemon", "RPG"),
        r"\bterraria\b": ("Terraria", "Sandbox"),
        r"\bstardew valley\b": ("Stardew Valley", "Farming Sim"),
        r"\bhollow knight\b": ("Hollow Knight", "Metroidvania"),
        r"\bcelest[ea]\b": ("Celeste", "Platformer"),
        r"\bhades\b": ("Hades", "Roguelike"),
        r"\bcuphead\b": ("Cuphead", "Run and Gun"),
        r"\bgod of war\b": ("God of War", "Action-Adventure"),
        r"\bhorizon (zero dawn|forbidden west)\b": ("Horizon", "Action RPG"),
        r"\bwitcher\s*3?\b": ("The Witcher 3", "RPG"),
        r"\bcyberpunk\s*2077\b": ("Cyberpunk 2077", "RPG"),
        r"\bskyrim\b": ("The Elder Scrolls V: Skyrim", "RPG"),
        r"\bfallout\b": ("Fallout", "RPG"),
        r"\bgrand theft auto\b|\bgta\s*v?\b": ("Grand Theft Auto", "Open World"),
        r"\bred dead redemption\b": ("Red Dead Redemption", "Open World"),
        r"\brocket league\b": ("Rocket League", "Sports"),
        r"\bfifa\b|\bea sports fc\b": ("EA Sports FC", "Sports"),
        r"\bamong us\b": ("Among Us", "Social Deduction"),
        r"\bslay the spire\b": ("Slay the Spire", "Deckbuilder"),
        r"\bbaldur'?s gate\s*3?\b": ("Baldur's Gate 3", "CRPG"),
    }

    def detect_from_text(
        self, text: str, source: str = "ocr"
    ) -> Optional[GameContext]:
        """First matching title wins; confidence scales with match count."""
        lowered = text.lower()
        for pattern, (name, genre) in self.GAME_PATTERNS.items():
            matches = re.findall(pattern, lowered)
            if matches:
                return GameContext(
                    game_name=name,
                    game_genre=genre,
                    detected_from=source,
                    confidence=min(1.0, 0.6 + 0.1 * len(matches)),
                )
        return None

    def detect_from_timeline(self, timeline_indexer) -> Optional[GameContext]:
        """Scan OCR + speech events for a recognizable title."""
        from gvl_tpu_torch.fusion.timeline import ModalityType

        texts = []
        for modality, source in (
            (ModalityType.OCR, "ocr"), (ModalityType.SPEECH, "speech")
        ):
            for event in timeline_indexer.query_by_modality(modality):
                texts.append((event.description, source))
        for text, source in texts:
            ctx = self.detect_from_text(text, source)
            if ctx is not None:
                return ctx
        return None


def create_search_enhanced_system_prompt(
    base_prompt: str, game_context: Optional[GameContext] = None
) -> str:
    """Append tool instructions (and the detected game) to a system prompt."""
    prompt = base_prompt + (
        "\n\nYou can call search_web(\"query\") for external game knowledge "
        "(boss strategies, lore, mechanics, items) by emitting "
        "<tool_call>search_web(\"query\")</tool_call> on its own line."
    )
    if game_context and game_context.game_name:
        prompt += f"\n\nCurrent game: {game_context.game_name}"
        if game_context.game_genre:
            prompt += f" ({game_context.game_genre})"
    return prompt
