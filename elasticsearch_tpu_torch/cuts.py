"""Where the port stops for now.

Each part of the JAX package that the port has not brought over yet
raises through `not_ported`, which names the ROADMAP.md queue 1 item
that brings it, so a caller learns what is missing instead of meeting a
quiet fallback or an ImportError.
"""

# the ROADMAP.md queue 1 item the cuts below point at (items 1-11, 12a
# (multi-node clusters) and 13-16 are ported)
MESH = "ROADMAP queue 1 item 12b (the serving mesh)"


def not_ported(what: str, where: str) -> NotImplementedError:
    """The error a cut raises: `what` is missing, `where` brings it."""
    return NotImplementedError(
        f"{what} is not part of the PyTorch port yet: it comes with a later "
        f"slice, {where}"
    )
