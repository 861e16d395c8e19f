"""MurmurHash3 x86_32 with Elasticsearch routing semantics.

Parity target: org.elasticsearch.cluster.routing.Murmur3HashFunction
(server/src/main/java/org/elasticsearch/cluster/routing/Murmur3HashFunction.java),
which encodes the routing string's UTF-16 code units as little-endian byte
pairs and applies Lucene's StringHelper.murmurhash3_x86_32 with seed 0.
Doc→shard routing is then `floorMod(hash, num_shards)` (OperationRouting /
IndexRouting in server/.../cluster/routing/).
"""

from __future__ import annotations

_MASK32 = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def murmurhash3_x86_32(data: bytes, seed: int = 0) -> int:
    """Returns the *signed* 32-bit murmur3 hash (Java int semantics)."""
    c1 = 0xCC9E2D51
    c2 = 0x1B873593
    h1 = seed & _MASK32
    n = len(data)
    rounded = n & ~0x3

    for i in range(0, rounded, 4):
        k1 = int.from_bytes(data[i : i + 4], "little")
        k1 = (k1 * c1) & _MASK32
        k1 = _rotl32(k1, 15)
        k1 = (k1 * c2) & _MASK32
        h1 ^= k1
        h1 = _rotl32(h1, 13)
        h1 = (h1 * 5 + 0xE6546B64) & _MASK32

    k1 = 0
    tail = n & 3
    if tail >= 3:
        k1 ^= data[rounded + 2] << 16
    if tail >= 2:
        k1 ^= data[rounded + 1] << 8
    if tail >= 1:
        k1 ^= data[rounded]
        k1 = (k1 * c1) & _MASK32
        k1 = _rotl32(k1, 15)
        k1 = (k1 * c2) & _MASK32
        h1 ^= k1

    h1 ^= n
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & _MASK32
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & _MASK32
    h1 ^= h1 >> 16

    # Java int is signed.
    return h1 - (1 << 32) if h1 >= (1 << 31) else h1


def murmur3_hash(routing: str) -> int:
    """ES Murmur3HashFunction.hash(String): UTF-16 code units as LE bytes.

    Python's utf-16-le encoding emits exactly Java's char sequence,
    including surrogate pairs for non-BMP code points.
    """
    return murmurhash3_x86_32(routing.encode("utf-16-le"), 0)


def calculate_num_routing_shards(num_shards: int) -> int:
    """MetadataCreateIndexService.calculateNumRoutingShards for 7.0+ indices:
    the partition space is num_shards * 2^numSplits (≥1 split, target 1024)
    so indices can later be split in place."""
    log2_max = 10  # log2(1024)
    log2_num = (num_shards - 1).bit_length()  # ceil(log2(num_shards))
    num_splits = max(1, log2_max - log2_num)
    return num_shards << num_splits


def shard_id(routing: str, num_shards: int, routing_num_shards: int | None = None) -> int:
    """doc→shard as IndexRouting does for 7.0+ indices:
    floorMod(murmur3(routing), routing_num_shards) / routing_factor,
    where routing_factor = routing_num_shards / num_shards.

    Python's % on ints already matches Java's Math.floorMod for negative
    hashes.
    """
    if routing_num_shards is None:
        routing_num_shards = calculate_num_routing_shards(num_shards)
    if routing_num_shards % num_shards != 0:
        # IndexMetadata validates routingFactor * numShards == routingNumShards
        raise ValueError(
            f"the number of routing shards [{routing_num_shards}] must be a "
            f"multiple of the number of shards [{num_shards}]"
        )
    routing_factor = routing_num_shards // num_shards
    return (murmur3_hash(routing) % routing_num_shards) // routing_factor
