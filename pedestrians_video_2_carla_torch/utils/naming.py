"""Run names for unnamed runs: ``adjective-noun`` strings drawn from two
fixed word lists (the same lists, and so the same names for the same
random stream, as the JAX package's)."""
import os
import random

_ADJECTIVES = (
    "amber", "bold", "brisk", "calm", "civic", "coral", "crisp", "deep",
    "dusky", "eager", "fleet", "fond", "glad", "grand", "hardy", "ideal",
    "jolly", "keen", "limber", "lively", "lucid", "mellow", "nimble",
    "noble", "opal", "pale", "quick", "rapid", "robust", "sage", "sleek",
    "solid", "spry", "stark", "steady", "swift", "tidy", "trusty", "vivid",
    "wise",
)

_NOUNS = (
    "anchor", "basin", "beacon", "bridge", "canyon", "cedar", "comet",
    "crane", "delta", "ember", "fjord", "garnet", "glade", "harbor",
    "heron", "inlet", "jetty", "kestrel", "lagoon", "lantern", "meadow",
    "mesa", "oriole", "osprey", "pylon", "quarry", "ridge", "sable",
    "sparrow", "spire", "summit", "tarn", "thicket", "tundra", "vale",
    "vertex", "willow", "wren", "zenith", "zephyr",
)


def random_run_name(rng: random.Random = None) -> str:
    """An ``adjective-noun`` run name, e.g. ``swift-lagoon``."""
    rng = rng or random.SystemRandom()
    return f"{rng.choice(_ADJECTIVES)}-{rng.choice(_NOUNS)}"


def unique_run_name(logs_dir: str, prefix: str = "",
                    rng: random.Random = None, max_tries: int = 10) -> str:
    """A run name whose log directory is reserved atomically when it is
    drawn: ``os.makedirs(exist_ok=False)`` either creates the directory or
    raises, across processes, so two unnamed runs never share
    ``{logs_dir}/{name}`` (they would interleave ``metrics.jsonl`` and
    overwrite each other's checkpoints). The 40 x 40 adjective-noun space
    collides quickly, so after three collisions a hex salt is appended and
    the draw always ends."""
    rng = rng or random.SystemRandom()
    for attempt in range(max_tries):
        name = f"{prefix}{rng.choice(_ADJECTIVES)}-{rng.choice(_NOUNS)}"
        if attempt >= 3:  # crowded namespace: salt guarantees progress
            name = f"{name}-{rng.randrange(16 ** 4):04x}"
        try:
            os.makedirs(os.path.join(logs_dir, name))
            return name
        except FileExistsError:
            continue
    raise RuntimeError(
        f"could not reserve a unique run dir under {logs_dir!r} "
        f"after {max_tries} tries")
