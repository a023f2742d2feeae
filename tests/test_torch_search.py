"""The port's game-knowledge search (``gvl_tpu_torch.agent.search``)
against ``gvl_tpu.agent.search``: cache, query augmentation, domain
boosting, the network paths with their two calls stubbed (no test waits on
DNS or on the 8 s timeout), the tool text and game detection.  Every
comparison is exact (strings, dicts, floats)."""

import json
import urllib.request

import numpy as np
import pytest

from gvl_tpu.agent import search as jsearch
from gvl_tpu.fusion import ModalityType as JModality
from gvl_tpu.fusion import TimelineIndexer as JTimeline
from gvl_tpu_torch.agent import search as tsearch
from gvl_tpu_torch.fusion import ModalityType as TModality
from gvl_tpu_torch.fusion import TimelineIndexer as TTimeline

DDG_PAGE = (
    '<html><body><a class="result__a" href="https://eldenring.wiki.fextralife.com/Margit">'
    'Margit the <b>Fell</b> Omen</a><a class="nav" href="/x">skip</a>'
    '<a class="result__a" href="https://www.random.com/margit">Margit guide</a>'
    '<a class="result__a" href="https://www.reddit.com/r/Eldenring/abc">reddit thread</a>'
    '<a class="result__a" href="https://empty.example/"></a></body></html>')


class _Page:
    def __init__(self, body: str):
        self._body = body.encode()

    def read(self):
        return self._body

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """Both packages' network calls stubbed: the DuckDuckGo client is
    absent, and ``urlopen`` serves a fixed results page (recording what it
    was asked) or fails as an offline host does."""
    import builtins

    real_import = builtins.__import__

    def guarded(name, *args, **kw):
        if name == "duckduckgo_search":
            raise ImportError("no duckduckgo_search")
        return real_import(name, *args, **kw)

    asked = []

    def urlopen(req, timeout=None):
        asked.append((req.full_url, timeout))
        if "offline" in req.full_url:
            raise OSError("network unreachable")
        return _Page(DDG_PAGE)

    monkeypatch.setattr(builtins, "__import__", guarded)
    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    return asked


def _dicts(results):
    return [r.to_dict() for r in results]


def test_cache_round_trip_ttl_and_clear(tmp_path):
    for mod, root in ((jsearch, tmp_path / "j"), (tsearch, tmp_path / "t")):
        cache = mod.SearchCache(root, ttl_hours=24)
        res = [mod.SearchResult("t", "s", "https://x.fandom.com/a", "x.fandom.com", 1.5)]
        cache.put("Query ", res)
        assert _dicts(mod.SearchCache(root).get("query")) == _dicts(res)
        assert mod.SearchCache(root, ttl_hours=0).get("query") is None   # expired: dropped
        assert not list(root.glob("*.json"))
        cache.put("q2", res)
        (root / "bad.json").write_text("{")
        cache.clear()
        assert not list(root.glob("*.json")) and cache.get("q2") is None
    assert sorted(p.name for p in (tmp_path / "j").iterdir()) == sorted(
        p.name for p in (tmp_path / "t").iterdir())
    assert jsearch.SearchCache(tmp_path)._key(" Elden RING ") == \
        tsearch.SearchCache(tmp_path)._key(" Elden RING ")


@pytest.mark.parametrize("category", ["general", "wiki", "guide", "lore", "boss",
                                      "character", "item", "mechanic", "other"])
@pytest.mark.parametrize("game", [None, "Elden Ring"])
def test_augment_query_equal(tmp_path, category, game):
    out = []
    for mod in (jsearch, tsearch):
        searcher = mod.GameKnowledgeSearcher(cache=mod.SearchCache(tmp_path / mod.__name__),
                                             enable_network=False)
        if game:
            searcher.set_game_context(game, "Action RPG")
        out.append([searcher._augment_query(q, category)
                    for q in ("margit weakness", "elden ring margit", "")])
    assert out[0] == out[1]


def test_boosting_equal(tmp_path):
    rng = np.random.default_rng(0)
    domains = ["random.com", "elden.fandom.com", "www.ign.com", "blog.example",
               "steamcommunity.com", "reddit.com", "news.example"]
    for _ in range(5):
        order = rng.permutation(len(domains))
        ranked = []
        for mod in (jsearch, tsearch):
            searcher = mod.GameKnowledgeSearcher(cache=mod.SearchCache(tmp_path / mod.__name__))
            results = [mod.SearchResult(f"r{i}", "", f"https://{domains[i]}/{i}", domains[i])
                       for i in order]
            ranked.append(_dicts(searcher._boost_gaming_domains(results)))
        assert ranked[0] == ranked[1]


def test_search_through_the_stubbed_network(tmp_path, no_network):
    """The HTML fallback parses the stubbed page the same way, the second
    search is served by the cache, an offline host and
    ``enable_network=False`` give empty results, and the tool text is
    equal."""
    got = {}
    for mod in (jsearch, tsearch):
        searcher = mod.GameKnowledgeSearcher(cache=mod.SearchCache(tmp_path / mod.__name__),
                                             max_results=2)
        searcher.set_game_context("Elden Ring")
        first = _dicts(searcher.search("margit", "boss"))
        n_asked = len(no_network)
        again = _dicts(searcher.search("margit", "boss"))
        assert again == first and len(no_network) == n_asked      # cache hit
        text = searcher.execute_tool_call("offline margit", "wiki")
        off = mod.GameKnowledgeSearcher(cache=mod.SearchCache(tmp_path / "off" / mod.__name__),
                                        enable_network=False)
        before = len(no_network)
        assert off.search("margit") == [] and len(no_network) == before
        helpers = [_dicts(getattr(searcher, f"search_{c}")("rennala"))
                   for c in ("wiki", "guide", "lore", "boss", "character", "item", "mechanic")]
        got[mod] = (first, text, helpers)
    assert got[jsearch] == got[tsearch]
    first, text, _ = got[tsearch]
    assert [r["source_domain"] for r in first] == ["eldenring.wiki.fextralife.com",
                                                   "www.reddit.com"]
    assert text == "[No search results found]"
    assert {t for _, t in no_network} == {8.0}
    assert all(u.startswith("https://html.duckduckgo.com/html/?q=") for u, _ in no_network)


def test_tool_definition_and_prompt_equal():
    assert (tsearch.GameKnowledgeSearcher.get_tool_definition()
            == jsearch.GameKnowledgeSearcher.get_tool_definition())
    for ctx in (None, ("Hades", "Roguelike"), ("Celeste", None), (None, "RPG")):
        want = jsearch.create_search_enhanced_system_prompt(
            "Base.", jsearch.GameContext(*ctx) if ctx else None)
        got = tsearch.create_search_enhanced_system_prompt(
            "Base.", tsearch.GameContext(*ctx) if ctx else None)
        assert got == want


TEXTS = ["ELDEN RING - Margit", "welcome to dark souls dark souls", "cs:go round 3",
         "GTA V heist", "pokémon battle", "nothing to see", "baldurs gate 3 act 2",
         "Horizon Forbidden West", "celesta", "dota2 and minecraft"]


def test_game_detection_equal():
    for text in TEXTS:
        for source in ("ocr", "speech"):
            want = jsearch.GameDetector().detect_from_text(text, source)
            got = tsearch.GameDetector().detect_from_text(text, source)
            assert (got is None) == (want is None), text
            if got is not None:
                assert vars(got) == vars(want), text


def test_detection_from_timeline_equal():
    """OCR events are read before speech events, as in JAX."""
    timelines = []
    for timeline_cls, modality in ((JTimeline, JModality), (TTimeline, TModality)):
        tl = timeline_cls()
        tl.add_event(1.0, modality.SPEECH, "we are playing hollow knight today")
        tl.add_event(2.0, modality.OCR, "HP 100")
        tl.add_event(3.0, modality.OCR, "Sekiro: shinobi execution")
        timelines.append(tl)
    want = jsearch.GameDetector().detect_from_timeline(timelines[0])
    got = tsearch.GameDetector().detect_from_timeline(timelines[1])
    assert vars(got) == vars(want) and got.game_name == "Sekiro: Shadows Die Twice"
    assert tsearch.GameDetector().detect_from_timeline(TTimeline()) is None
    assert json.dumps(vars(got)) == json.dumps(vars(want))
