"""Where the port stops for now.

Each part of the JAX package that the port has not brought over yet
raises through `not_ported`, which names the ROADMAP.md queue 1 item
that brings it, so a caller learns what is missing instead of meeting a
quiet fallback or an ImportError.
"""

# ROADMAP.md queue 1 items the cuts below point at (items 1-6, 8-10
# and 15 are ported)
RERANK = "ROADMAP queue 1 item 7 (second-stage rerank)"
DEVICE_BUILD = "ROADMAP queue 1 item 11 (device segment builds)"
MESH = "ROADMAP queue 1 item 12 (mesh and multi-node cluster)"
DISK = "ROADMAP queue 1 item 13 (on-disk segments and snapshots)"
FETCH = "ROADMAP queue 1 item 14 (highlight, scripts and reindex)"
NODES = "ROADMAP queue 1 item 16 (phrase and the remaining query nodes)"


def not_ported(what: str, where: str) -> NotImplementedError:
    """The error a cut raises: `what` is missing, `where` brings it."""
    return NotImplementedError(
        f"{what} is not part of the PyTorch port yet: it comes with a later "
        f"slice, {where}"
    )
