"""grain's global shuffle, in numpy.

``grain.MapDataset.shuffle`` places record ``i`` of an epoch at
``index_shuffle(i, max_index=n - 1, seed, rounds=4)``: a Simon-style
Feistel cipher over the smallest even block of at least 16 bits that
holds ``ceil(log2(max_index))`` bits, walked in cycles until the result
is at most ``max_index``.  The round keys are ``std::seed_seq({seed})``'s
first ``rounds`` words.  This is a copy of grain's compiled
``index_shuffle`` (grain, Apache-2.0: ``grain/_src/python/experimental/
index_shuffle/index_shuffle.cc``), not of the pure-Python twin grain
ships, which is another permutation.  Its quirks are kept: a
``max_index`` that is a power of two gets a block one bit short, so its
last index wraps onto the first.

``shuffle_seed`` is the seed grain's shuffle reads when the pipeline is
seeded one node above it (``pipe.seed(s).shuffle()``).
"""

import functools
import math

import numpy as np

MIN_BLOCK_BITS = 16
U32 = 0xFFFFFFFF


def shuffle_seed(grain_seed: int) -> int:
    """The seed of a shuffle one node below ``.seed(grain_seed)``: grain
    aggregates ``[seed, depth]`` into a ``SeedSequence``."""
    return int(np.random.SeedSequence([int(grain_seed), 1]).generate_state(1, np.uint32)[0])


def seed_seq_generate(seeds, n: int) -> list:
    """``std::seed_seq(seeds).generate`` of ``n`` 32-bit words (the C++
    standard's algorithm, [rand.util.seedseq])."""
    v = [int(s) & U32 for s in seeds]
    s = len(v)
    if n == 0:
        return []
    b = [0x8B8B8B8B] * n
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def mix(x):
        return x ^ (x >> 27)

    for k in range(m):
        r1 = (1664525 * mix(b[k % n] ^ b[(k + p) % n] ^ b[(k + n - 1) % n])) & U32
        if k == 0:
            r2 = (r1 + s) & U32
        elif k <= s:
            r2 = (r1 + k % n + v[k - 1]) & U32
        else:
            r2 = (r1 + k % n) & U32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & U32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & U32
        b[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * mix((b[k % n] + b[(k + p) % n] + b[(k + n - 1) % n]) & U32)) & U32
        r4 = (r3 - k % n) & U32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return b


def block_bits(max_index: int) -> int:
    """The cipher's block width for ``max_index``: ``ceil(log2)`` of it as
    a double, rounded up to even, at least 16."""
    bits = int(math.ceil(math.log2(float(max_index))))
    bits += bits % 2
    bits = max(bits, MIN_BLOCK_BITS)
    if bits > 64:
        raise ValueError(f"max_index {max_index} needs more than 64 bits")
    return bits


def _encrypt(x: np.ndarray, keys, half: int) -> np.ndarray:
    mask = np.uint64((1 << half) - 1)

    def rotl(v, r):
        return ((v << np.uint64(r)) | (v >> np.uint64(half - r))) & mask

    def f(v):
        return rotl(v, 2) ^ (rotl(v, 1) & rotl(v, 8))

    left = (x >> np.uint64(half)) & mask
    right = x & mask
    for i in range(0, len(keys), 2):
        left ^= f(right) ^ (np.uint64(keys[i]) & mask)
        right ^= f(left) ^ (np.uint64(keys[i + 1]) & mask)
    return (left << np.uint64(half)) | right


def _walk(x: np.ndarray, max_index: int, keys, half: int) -> np.ndarray:
    """Encrypts each element, again while it is above ``max_index``."""
    out = _encrypt(x, keys, half)
    todo = np.flatnonzero(out > np.uint64(max_index))
    while todo.size:
        out[todo] = _encrypt(out[todo], keys, half)
        todo = todo[out[todo] > np.uint64(max_index)]
    return out


@functools.lru_cache(maxsize=8)
def _small_permutation(max_index: int, seed: int, rounds: int) -> np.ndarray:
    """The whole permutation of ``[0, max_index]`` when the 16-bit block
    is at least four times the range, so that walks are long: the cipher
    tabled over the block, then each entry's first value in range found
    by pointer doubling (a walk of ``d`` steps from a walk of ``d / 2``)."""
    keys = seed_seq_generate([seed], rounds)
    table = _encrypt(np.arange(1 << MIN_BLOCK_BITS, dtype=np.uint64), keys, MIN_BLOCK_BITS // 2).astype(np.int64)
    first = table
    for _ in range(MIN_BLOCK_BITS + 1):
        out = first > max_index
        if not out.any():
            break
        first = np.where(out, first[first], first)
    perm = first[: max_index + 1].copy()
    perm.flags.writeable = False
    return perm


def index_shuffle(index, max_index: int, seed: int, rounds: int = 4):
    """Where grain's shuffle puts ``index`` (an int or an array of them)
    in a permutation of ``[0, max_index]``; numpy over an array, each
    element cycle-walked until it lands in range."""
    if rounds < 4 or rounds % 2:
        raise ValueError(f"rounds must be even and at least 4, got {rounds}")
    scalar = np.ndim(index) == 0
    x = np.array(index, dtype=np.uint64, ndmin=1)
    if max_index == 0:
        out = np.zeros_like(x)
    elif block_bits(max_index) == MIN_BLOCK_BITS and 4 * (max_index + 1) <= 1 << MIN_BLOCK_BITS:
        # the block's low bits wrap an index above it, as the cipher does
        low = x & np.uint64((1 << MIN_BLOCK_BITS) - 1)
        perm = _small_permutation(int(max_index), int(seed) & U32, int(rounds))
        # an index beyond the range starts its walk where the cipher puts it
        inside = low <= np.uint64(max_index)
        out = np.empty_like(x)
        out[inside] = perm[low[inside].astype(np.int64)]
        if not inside.all():
            keys = seed_seq_generate([int(seed) & U32], rounds)
            out[~inside] = _walk(x[~inside], max_index, keys, MIN_BLOCK_BITS // 2)
    else:
        keys = seed_seq_generate([int(seed) & U32], rounds)
        out = _walk(x, max_index, keys, block_bits(max_index) // 2)
    return int(out[0]) if scalar else out.astype(np.int64)


def epoch_permutation(n: int, seed: int, rounds: int = 4) -> np.ndarray:
    """``p[i] = index_shuffle(i, n - 1, seed, rounds)`` for one epoch of
    ``n`` records."""
    if n <= 0:
        return np.zeros(0, np.int64)
    return index_shuffle(np.arange(n, dtype=np.uint64), n - 1, seed, rounds)
