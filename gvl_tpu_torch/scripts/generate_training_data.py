"""Generate causal-chain LoRA training data (chat format, original): the
port's copy of ``scripts/generate_training_data.py``, whose JSON it writes
byte for byte for the same ``--seed`` and ``--count``.

Hand-written causal-chain Q&A datasets are timeline-cited with a
mandatory ``**Reasoning:**``/``**Answer:**`` structure; this produces an
equivalent-role dataset programmatically: randomized gameplay scenarios
(boss fights, item chains, health swings, glitches, objective chains)
rendered through varied question/answer templates, every answer citing
``[MM:SS]`` timestamps that appear in its own reasoning — the exact
behavior the LoRA is meant to reinforce.

Usage:
    python -m gvl_tpu_torch.scripts.generate_training_data \
        --out data/training/lora_training_pairs.json --count 120
"""

from __future__ import annotations

import argparse
import json
import random
from pathlib import Path


def mmss(t: int) -> str:
    return f"[{t // 60:02d}:{t % 60:02d}]"


ENTITIES = ["boss", "player", "dragon", "knight", "turret", "golem",
            "wraith", "pilot", "mech", "sorcerer"]
ITEMS = ["health potion", "mana crystal", "flame sword", "shield rune",
         "speed elixir", "thunder core", "frost amulet"]
ZONES = ["the lava bridge", "the crystal cave", "the hangar",
         "the throne room", "the canyon pass", "the reactor core"]


def scenario_boss(rng) -> tuple[str, str]:
    boss = rng.choice(ENTITIES[:1] + ENTITIES[2:])
    t0 = rng.randrange(30, 400)
    t1, t2, t3 = t0 + rng.randrange(4, 15), t0 + rng.randrange(16, 30), \
        t0 + rng.randrange(31, 50)
    hp0, hp1 = rng.randrange(60, 95), rng.randrange(5, 40)
    q = rng.choice([
        f"How did the fight against the {boss} go?",
        f"What happened to the {boss} around {mmss(t1)[1:-1]}?",
        f"Why did the {boss}'s health drop?",
    ])
    a = (
        f"**Reasoning:** The timeline shows the {boss} detected at "
        f"{mmss(t0)} with the OCR reading \"HP {hp0}%\". At {mmss(t1)} "
        f"the audio event \"sword clash\" co-occurs with the visual "
        f"detection \"player attacking {boss}\", and by {mmss(t2)} the "
        f"HP readout falls to {hp1}%. The attack at {mmss(t1)} precedes "
        f"and explains the health drop at {mmss(t2)}.\n\n"
        f"**Answer:** The player engaged the {boss} at {mmss(t1)}; its "
        f"health fell from {hp0}% to {hp1}% by {mmss(t2)}"
        + (f", and it was defeated at {mmss(t3)}."
           if rng.random() < 0.5 else ".")
    )
    return q, a


def scenario_item(rng) -> tuple[str, str]:
    item = rng.choice(ITEMS)
    zone = rng.choice(ZONES)
    t0 = rng.randrange(20, 500)
    t1 = t0 + rng.randrange(3, 12)
    gain = rng.randrange(20, 60)
    q = rng.choice([
        f"When was the {item} used?",
        f"What effect did the {item} have?",
        f"Did picking up the {item} matter?",
    ])
    a = (
        f"**Reasoning:** The {item} is first detected in {zone} at "
        f"{mmss(t0)}. At {mmss(t1)} the OCR shows \"+{gain} HP\" "
        f"immediately after the pickup animation, linking the item use "
        f"to the stat change.\n\n"
        f"**Answer:** The {item} was picked up at {mmss(t0)} and used at "
        f"{mmss(t1)}, restoring {gain} HP."
    )
    return q, a


def scenario_glitch(rng) -> tuple[str, str]:
    ent = rng.choice(ENTITIES)
    zone = rng.choice(ZONES)
    t0 = rng.randrange(40, 600)
    kind = rng.choice(["clipped through the floor",
                       "flickered between two positions",
                       "froze mid-animation",
                       "rendered without textures"])
    q = rng.choice([
        "Is there a visual glitch in this video?",
        f"Did anything look wrong near {mmss(t0)[1:-1]}?",
        "Were there any rendering anomalies?",
    ])
    a = (
        f"**Reasoning:** The timeline records the {ent} in {zone} at "
        f"{mmss(t0)} with the anomalous visual state \"{ent} {kind}\"; "
        f"neighboring frames at {mmss(t0 - 2)} and {mmss(t0 + 2)} show "
        f"the normal state, so the anomaly is localized, which matches "
        f"a rendering glitch rather than an intended animation.\n\n"
        f"**Answer:** Yes — the {ent} {kind} at {mmss(t0)}."
    )
    return q, a


def scenario_objective(rng) -> tuple[str, str]:
    zone_a, zone_b = rng.sample(ZONES, 2)
    t0 = rng.randrange(10, 300)
    t1 = t0 + rng.randrange(20, 90)
    t2 = t1 + rng.randrange(10, 60)
    q = rng.choice([
        "Summarize the player's progress.",
        "What objectives were completed?",
        f"What happened between {mmss(t0)[1:-1]} and {mmss(t2)[1:-1]}?",
    ])
    a = (
        f"**Reasoning:** At {mmss(t0)} the OCR shows \"OBJECTIVE: reach "
        f"{zone_a}\". The player arrives at {zone_a} at {mmss(t1)} "
        f"(visual detection), after which a new objective \"clear "
        f"{zone_b}\" appears at {mmss(t2)}. The objective text change "
        f"follows the arrival, confirming completion.\n\n"
        f"**Answer:** The player reached {zone_a} at {mmss(t1)}, "
        f"completing the first objective, and received the next "
        f"objective for {zone_b} at {mmss(t2)}."
    )
    return q, a


def scenario_negative(rng) -> tuple[str, str]:
    ent = rng.choice(ENTITIES)
    t0 = rng.randrange(30, 500)
    q = rng.choice([
        f"Did the {ent} use its special ability?",
        "Was there a boss fight in the first minute?",
        f"Did the player die near {mmss(t0)[1:-1]}?",
    ])
    a = (
        f"**Reasoning:** Searching the timeline around {mmss(t0)} and "
        f"across the video yields no matching visual, audio, or OCR "
        f"event for that question; the nearest recorded events are "
        f"routine movement at {mmss(max(t0 - 8, 0))} and ambient audio "
        f"at {mmss(t0 + 6)}. Absent evidence, the honest response is "
        f"that the timeline does not support it.\n\n"
        f"**Answer:** No — the timeline shows no such event; the "
        f"closest activity is ordinary movement at "
        f"{mmss(max(t0 - 8, 0))}."
    )
    return q, a


def scenario_tool_call(rng) -> tuple[str, str]:
    """Teach the <tool_call> protocol: unknown lore → search, then a
    cited answer (the agentic search loop)."""
    boss = rng.choice(ENTITIES)
    game = rng.choice(["Eternal Depths", "Starfall Arena", "Rune Keep",
                       "Iron Horizon"])
    t0 = rng.randrange(30, 400)
    q = rng.choice([
        f"What's the best strategy against the {boss}?",
        f"What drops does the {boss} give in {game}?",
        f"Is the {boss} weak to anything?",
    ])
    a = (
        f"**Reasoning:** The timeline shows the {boss} engaged at "
        f"{mmss(t0)}, but strategy and drop information is external game "
        f"knowledge, not observable in the video — this requires a web "
        f"search.\n\n"
        f"<tool_call>search_web(\"{game} {boss} strategy weakness\")"
        f"</tool_call>"
    )
    return q, a


SCENARIOS = [scenario_boss, scenario_item, scenario_glitch,
             scenario_objective, scenario_negative, scenario_tool_call]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out",
                        default="data/training/lora_training_pairs.json")
    parser.add_argument("--count", type=int, default=120)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    rng = random.Random(args.seed)
    samples = []
    for i in range(args.count):
        q, a = SCENARIOS[i % len(SCENARIOS)](rng)
        samples.append({"messages": [
            {"role": "user", "content": q},
            {"role": "assistant", "content": a},
        ]})
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(samples, indent=1))
    print(f"wrote {len(samples)} samples to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
