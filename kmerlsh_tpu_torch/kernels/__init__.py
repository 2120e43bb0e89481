"""The engine's hand-written CUDA kernels, each beside its plain PyTorch
version.

A wrapper takes the plain version for tensors on the CPU. For tensors on a
CUDA device it launches its kernel (built from ``kmerlsh_tpu_torch/csrc`` at
first use, see :mod:`.build`) or raises; it never falls back. ``launches``
counts the kernel launches of each wrapper, so that a run can show that its
main path went through the kernels.

| wrapper              | source                 | replaces (kmerlsh_tpu/)                   |
| -------------------- | ---------------------- | ----------------------------------------- |
| abundance_transform  | csrc/lsh_keys.cu       | ops/transform.py abundance_transform_t    |
| lsh_keys             | csrc/lsh_keys.cu       | ops/lsh.py signatures_t + engine.py       |
| (lsh_keys_rows)      |                        | _combined_sort_key                        |
| sort_keys            | csrc/sort_keys.cu      | engine.py _sort_state / compact_sort /    |
|                      |                        | _finalize_grouped key sorts (lax.sort)    |
| permute_state        | csrc/permute_state.cu  | engine.py _sort_state / compact_sort      |
| (to_rows,            |                        | payloads                                  |
| permute_rows)        |                        |                                           |
| chain_collapse       | csrc/chain_collapse.cu | engine.py chain_collapse + parent fold    |
| (chain_collapse_rows)| (+ permute_state.cu's  | (and parallel/dist.py's local fold), with |
|                      | transpose)             | the payload move of its sort              |
| finalize             | csrc/finalize.cu       | engine.py _finalize_grouped               |
| wrs_verdicts         | csrc/ttest.cu          | ops/ttest.py t_cdf, studentttest2,        |
|                      |                        | wrs_verdicts                              |
| key_directory        | csrc/reads.cu          | ops/reads.py _device_score_kernel (the    |
|                      |                        | search's top levels, once per key set)    |
| score_reads          | csrc/reads.cu          | ops/reads.py _device_score_kernel         |
| exchange_window      | csrc/exchange.cu       | parallel/dist.py _window_positions and    |
|                      |                        | the window gather                         |
| exchange_fold        | csrc/exchange.cu       | parallel/dist.py _realign_to, the global  |
|                      |                        | parent fold and the write-back            |
| pairing_rounds       | csrc/pairing.cu        | engine.py pairing_merge (its rounds)      |
| draw_planes          | csrc/planes.cu         | ops/lsh.py:27-30 jax.random.normal (each  |
|                      |                        | iteration's hyperplanes, in-graph)        |

A chain session (cluster/engine.py) carries its state between iterations as
rows: row m holds column m's S values, its size and its slot as 32-bit
words, padded to :func:`row_words` (int32 [M, W]). ``to_rows`` makes it,
``lsh_keys_rows`` and ``chain_collapse_rows`` read it, the latter writes
it, and ``permute_rows`` takes it back to [S, M] columns; every other
wrapper keeps the [S, M] contract.
"""

from __future__ import annotations

import torch

from kmerlsh_tpu_torch.ops import lsh, rng, transform, ttest
from kmerlsh_tpu_torch.ops.lsh import BIG_KEY
from kmerlsh_tpu_torch.ops.segment import alive_rank_in_segment, segment_starts

MAX_CHAIN_LOG = 15   # chains are cut at positions that are multiples of 2^15
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
STAGE_BYTES = 48 * 1024   # the tile a block of K2 or K3 stages, at most
CHAIN_THREADS = 128       # threads of a K3 block, at least (a thread a
                          # position where a block has more positions)
LSH_PLANES = (4, 8, 12, 16, 20, 24, 28, 30)   # K1b's sign-plane counts
LSH_RING = 8              # value rows a K1b block keeps in flight
LSH_ROW_PIECES = 2        # 16-byte pieces of each row a stage of K1b on
                          # rows holds
LSH_ROW_RING = 3          # stages a K1b block on rows keeps
WRS_WARPS = 4             # warps a K6 block
WRS_TILES = 4             # 32-row tiles a K6 warp takes of its block's rows,
                          # at most
WRS_CHUNK = 124           # columns a K6 warp stages a row, at most
WRS_BUCKETS = 32          # buckets of x a K6 block sorts each pair's rows by
WRS_FILL = 1024           # K6 blocks fewer tiles a warp are to leave
WRS_MIN_BLOCKS = 4        # K6 blocks a SM holds, below which a warp takes
                          # fewer tiles to fit one more block
SMEM_SM = 233472          # shared memory of one SM (1 KB of it a block)

SORT_THREADS = 256        # threads of a K9 tile block
SORT_KEYS_A_THREAD = 16   # keys a K9 thread takes of its block's tile
SORT_DIGIT_BITS = 8       # K9's widest digit: a thread a digit
SORT_HIST_INTS = 1 << 19  # ints of K9's histogram rows, at most
SORT_ONE_MAX = 1 << 18    # keys K9's one-launch route takes, at most
SORT_ROUTES = ("one launch", "one sweep", "three launches a pass")
                          # K9's routes, by their C code

PAIR_THREADS = 512        # threads of a K10 short-segment block
PAIR_PER_SM = 2           # K10 short-segment blocks a SM, where they fit
PAIR_CAP_MAX = 2048       # K10's capacity C (positions a window), at most
PAIR_STATIC = 1024        # bytes of a K10 block's static shared memory, at
                          # most
PAIR_LONG_THREADS = 256   # threads of a K10 long-segment block
PAIR_LONG_ITEMS = 8       # consecutive positions such a thread scans
PAIR_LONG_GRID_MAX = 1024 # blocks of K10's cooperative launch, at most
PAIR_M_MAX = 2**31 - 1 - 8192   # K10's positions, at most (int32)

launches: dict[str, int] = {
    "abundance_transform": 0, "lsh_keys": 0, "sort_keys": 0,
    "permute_state": 0, "to_rows": 0, "permute_rows": 0,
    "chain_collapse": 0, "finalize": 0, "wrs_verdicts": 0, "key_directory": 0,
    "score_reads": 0, "exchange_window": 0, "exchange_fold": 0,
    "pairing_rounds": 0, "draw_planes": 0,
}
# kernel launches on the card of the wrappers that make more than one a
# call (K10: its plan's "launches")
card_launches: dict[str, int] = {"pairing_rounds": 0}


def reset_launches() -> None:
    for counts in (launches, card_launches):
        for k in counts:
            counts[k] = 0


def free_bits(h: int) -> int:
    """Low key bits left for the secondary projection at h bucket bits."""
    return min(max(30 - h, 0), 29)


def _on_cuda(*tensors: torch.Tensor) -> bool:
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return True


def _check(t: torch.Tensor, dtype: torch.dtype, name: str,
           ndim: int = 1) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: want {ndim}-d {dtype}, got "
                         f"{t.dim()}-d {t.dtype}")
    if t.numel() and (t.stride(-1) != 1
                      or (ndim == 1 and not t.is_contiguous())):
        raise ValueError(f"{name}: the last axis must be contiguous")


def _launch(fn, *args) -> None:
    from kmerlsh_tpu_torch.kernels.build import load

    lib = load()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err}")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


# --- K1: abundance transform ----------------------------------------------

def abundance_transform_plain(counts: torch.Tensor, v_kmers: torch.Tensor):
    values_t, keep = transform.abundance_transform_t(counts, v_kmers)
    return values_t, keep.to(torch.int32)


def abundance_transform(counts: torch.Tensor, v_kmers: torch.Tensor):
    """uint16 counts [S, M] → (values f32 [S, M], sizes int32 [M], 1 where
    the column passes the keep filter)."""
    if not _on_cuda(counts, v_kmers):
        return abundance_transform_plain(counts, v_kmers)
    _check(counts, torch.uint16, "counts", 2)
    _check(v_kmers, torch.float32, "v_kmers")
    counts = counts.contiguous()
    S, M = counts.shape
    values = torch.empty((S, M), dtype=torch.float32, device=counts.device)
    sizes = torch.empty(M, dtype=torch.int32, device=counts.device)
    if M:
        _launch("kl_transform", counts.data_ptr(), v_kmers.data_ptr(), S, M,
                transform.keep_threshold(S), values.data_ptr(),
                sizes.data_ptr())
        launches["abundance_transform"] += 1
    return values, sizes


# --- K1: LSH keys -----------------------------------------------------------

def lsh_keys_plain(values_t, sizes, hyperplanes, h: int):
    keys, proj = lsh.signatures_t(values_t, hyperplanes, h)
    keys = torch.where(sizes > 0, keys, BIG_KEY)
    return lsh.combined_sort_key(keys, proj, sizes, h), proj


def lsh_plan(S: int, h: int, rows: bool = False) -> dict:
    """Launch arithmetic of ``lsh_keys`` at S rows and h bucket bits:
    ``planes``, the sign planes the kernel computes (the least of
    LSH_PLANES ≥ h; the secondary plane comes on top); blocks of
    ``threads`` threads and ``cols`` columns; ``smem``, the bytes of a
    block's S rows of the planes in use padded to whole float4s and of its
    ring of LSH_RING value rows, or with ``rows`` (``lsh_keys_rows``) of
    LSH_ROW_RING stages of LSH_ROW_PIECES 16-byte pieces of each of its
    rows."""
    if not 1 <= h <= lsh.H_MAX:
        raise ValueError(f"h = {h} outside [1, {lsh.H_MAX}]")
    T = next(t for t in LSH_PLANES if t >= h)
    threads, cols = 128, 4 * 128
    ring = (16 * LSH_ROW_RING * LSH_ROW_PIECES * cols if rows
            else 4 * LSH_RING * cols)
    smem = 16 * S * -(-(T + 1) // 4) + ring
    if smem > SMEM_LIMIT:
        raise ValueError(f"lsh_keys: S = {S} rows need {smem} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    return dict(planes=T, smem=smem, threads=threads, cols=cols)


def lsh_keys(values_t: torch.Tensor, sizes: torch.Tensor,
             hyperplanes: torch.Tensor, h: int):
    """values f32 [S, M] (rows may be strided), sizes int32 [M], planes f32
    [S, H_MAX + 1], 1 ≤ h ≤ H_MAX → (combined sort key int32 [M] with dead
    columns at BIG_KEY, secondary projection f32 [M])."""
    if not _on_cuda(values_t, sizes, hyperplanes):
        return lsh_keys_plain(values_t, sizes, hyperplanes, h)
    _check(values_t, torch.float32, "values_t", 2)
    _check(sizes, torch.int32, "sizes")
    planes = hyperplanes.to(torch.float32).contiguous()
    S, M = values_t.shape
    if planes.shape != (S, lsh.H_MAX + 1):
        raise ValueError(f"hyperplanes: want {(S, lsh.H_MAX + 1)}, got "
                         f"{tuple(planes.shape)}")
    plan = lsh_plan(S, h)
    keys = torch.empty(M, dtype=torch.int32, device=values_t.device)
    proj = torch.empty(M, dtype=torch.float32, device=values_t.device)
    minmax = torch.empty(2, dtype=torch.int32, device=values_t.device)
    if M:
        _launch("kl_lsh_keys", values_t.data_ptr(), values_t.stride(0), S, M,
                planes.data_ptr(), sizes.data_ptr(), h, plan["planes"],
                plan["smem"], free_bits(h), keys.data_ptr(), proj.data_ptr(),
                minmax.data_ptr())
        launches["lsh_keys"] += 1
    return keys, proj


def lsh_keys_rows_plain(rows, sizes, hyperplanes, h: int):
    return lsh_keys_plain(rows_values(rows, hyperplanes.shape[0]), sizes,
                          hyperplanes, h)


def lsh_keys_rows(rows: torch.Tensor, sizes: torch.Tensor,
                  hyperplanes: torch.Tensor, h: int):
    """``lsh_keys`` on a chain session's row state: rows int32 [M, W]
    (:func:`to_rows`' layout; S, the planes' rows), sizes int32 [M] as a
    column → the same keys and projections, bit for bit."""
    if not _on_cuda(rows, sizes, hyperplanes):
        return lsh_keys_rows_plain(rows, sizes, hyperplanes, h)
    _check(rows, torch.int32, "rows", 2)
    _check(sizes, torch.int32, "sizes")
    planes = hyperplanes.to(torch.float32).contiguous()
    S = planes.shape[0]
    M, W = rows.shape
    if (planes.shape != (S, lsh.H_MAX + 1) or W != row_words(S)
            or not rows.is_contiguous() or sizes.shape[0] != M):
        raise ValueError(f"lsh_keys_rows: rows {tuple(rows.shape)}, sizes "
                         f"{tuple(sizes.shape)}, planes {tuple(planes.shape)}")
    plan = lsh_plan(S, h, rows=True)
    keys = torch.empty(M, dtype=torch.int32, device=rows.device)
    proj = torch.empty(M, dtype=torch.float32, device=rows.device)
    minmax = torch.empty(2, dtype=torch.int32, device=rows.device)
    if M:
        _launch("kl_lsh_keys_rows", rows.data_ptr(), W, S, M,
                planes.data_ptr(), sizes.data_ptr(), h, plan["planes"],
                plan["smem"], free_bits(h), keys.data_ptr(), proj.data_ptr(),
                minmax.data_ptr())
        launches["lsh_keys"] += 1
    return keys, proj


# --- K9: stable key sort -----------------------------------------------------

def _align(n: int) -> int:
    return -(-n // 256) * 256


def sort_plan(M: int, bits: int, route: str | None = None) -> dict:
    """Launch arithmetic of ``sort_keys`` on M keys of ``bits`` bits:
    ``passes`` passes of a ``digit``-bit digit (the fewest passes of at
    most SORT_DIGIT_BITS bits, the digit as narrow as they allow) over
    ``blocks`` tiles of ``tile`` keys, a block of SORT_THREADS threads a
    tile, on a ``route`` of SORT_ROUTES (by default "one launch" up to
    SORT_ONE_MAX keys, above it "one sweep", or "three launches a pass"
    for one pass): "one launch", one cooperative launch that runs every
    pass with grid-wide syncs; "one sweep", one histogram launch of every
    pass over ``hist_blocks`` blocks, one launch of the digits' starts,
    then a launch a pass (the first pass's tile offsets from the
    histogram, a later one's by look-back); "three launches a pass", a
    pass's histogram, its rows' scans and its scatter. ``smem``, the
    bytes of a tile block's shared memory: its tile's keys and payloads,
    two ints a digit (its start in the tile and out there) and 16-bit digit
    counters for each of its warps; ``scratch``, the bytes of the one
    scratch allocation (256-byte aligned parts: the tiles' counts, and the
    digits' totals after them on the three-launch route; on the one-sweep
    route also the 64-bit status words, 2^digit a tile, the
    histogram rows, the starts and the tickets; the ping-pong pair of keys
    and order where passes > 1); ``launches``. Positions are int32: M stays
    a tile below 2^31."""
    if not 1 <= bits <= 31:
        raise ValueError(f"sort_keys: bits = {bits} outside [1, 31]")
    passes = -(-bits // SORT_DIGIT_BITS)
    if route is None:
        route = SORT_ROUTES[0 if M <= SORT_ONE_MAX else 1 if passes > 1
                            else 2]
    if route not in SORT_ROUTES:
        raise ValueError(f"sort_keys: no route {route!r}")
    one, sweep, three = (route == r for r in SORT_ROUTES)
    if one and M > SORT_ONE_MAX:
        raise ValueError(f"sort_keys: {M} keys in one launch")
    digit = -(-bits // passes)
    radix = 1 << digit
    tile = SORT_THREADS * SORT_KEYS_A_THREAD
    if M > 2**31 - 1 - tile:
        raise ValueError(f"sort_keys: {M} keys")   # int32 positions
    blocks = -(-M // tile)
    smem = 8 * tile + (8 + 2 * (SORT_THREADS // 32)) * radix
    if smem > SMEM_LIMIT:
        raise ValueError(f"sort_keys: {digit}-bit digits need {smem} bytes "
                         f"of shared memory, more than {SMEM_LIMIT}")
    # a histogram block a tile, as far as SORT_HIST_INTS rows of every
    # pass's bins allow
    hist_blocks = (min(blocks, SORT_HIST_INTS // (passes * radix)) if sweep
                   else 0)
    scratch = (2 * _align(4 * M) if passes > 1 else 0) + _align(
        4 * (blocks + three) * radix)
    if sweep:
        scratch += (_align(8 * blocks * radix)
                    + _align(4 * hist_blocks * passes * radix)
                    + _align(4 * passes * radix) + _align(4 * passes))
    return dict(route=route, digit=digit, passes=passes, tile=tile,
                blocks=blocks, hist_blocks=hist_blocks, smem=smem,
                scratch=scratch,
                launches=1 if one else 2 + passes if sweep else 3 * passes)


# keys passed to sort_keys or sort_keys_plain in this process, on the card
# and the CPU alike (engine.LAST_SESSION["sorted_keys"] is a session's delta)
sorted_keys = 0


def sort_keys_plain(key, bits: int):
    global sorted_keys
    sorted_keys += key.shape[0]
    skey, order = torch.sort(key, stable=True)
    return skey, order.to(torch.int32)


def sort_keys(key: torch.Tensor, bits: int,
              scratch: torch.Tensor | None = None):
    """Stable ascending sort of int32 keys [M] in [0, 2^bits), 1 ≤ bits ≤
    31 → (the sorted keys, int32 order [M]: sorted[i] = key[order[i]],
    ties in input order). The kernel reads only the low ``bits`` bits. It
    runs on ``scratch`` (uint8 on the key's card, the plan's ``scratch``
    bytes, whatever they hold) where one is given, else on a new one."""
    global sorted_keys
    if not 1 <= bits <= 31:
        raise ValueError(f"sort_keys: bits = {bits} outside [1, 31]")
    if not _on_cuda(key):
        return sort_keys_plain(key, bits)
    _check(key, torch.int32, "key")
    M = key.shape[0]
    sorted_keys += M
    skey = torch.empty_like(key)
    order = torch.empty_like(key)
    if M:
        plan = sort_plan(M, bits)
        if scratch is None:
            scratch = torch.empty(plan["scratch"], dtype=torch.uint8,
                                  device=key.device)
        else:
            _check(scratch, torch.uint8, "scratch")
            if (scratch.device != key.device
                    or scratch.numel() != plan["scratch"]):
                raise ValueError(f"sort_keys: want {plan['scratch']} "
                                 f"scratch bytes on {key.device}")
        _launch("kl_sort_keys", key.data_ptr(), M, bits,
                SORT_ROUTES.index(plan["route"]), plan["digit"],
                plan["passes"], plan["tile"], plan["blocks"],
                plan["hist_blocks"], plan["smem"], scratch.data_ptr(),
                plan["scratch"], skey.data_ptr(), order.data_ptr())
        launches["sort_keys"] += 1
    return skey, order


# --- K2: permute ------------------------------------------------------------

def stage_words(W: int) -> int:
    """The words of a profile-major row of W words (a multiple of 4) when
    a block stages it in shared memory: 16-byte aligned, an odd number of
    16-byte pieces (W where W = 4 mod 8, else W + 4), so that the 16-byte
    reads of eight neighbouring rows cover the 32 banks (csrc/common.cuh
    ``kl_stage_ld``)."""
    return W if W % 8 else W + 4


def row_words(S: int) -> int:
    """The words of a row of a chain session's row state: the S values,
    the size and the slot in whole 16-byte pieces (the least multiple of 4
    at or above S + 2). A random row's read still takes whole 32-byte
    sectors, as many as a row padded to them, while the rows read and
    written in order move only these bytes: 20 words at S = 18 against 24,
    128 at S = 124 either way."""
    return -(-(S + 2) // 4) * 4


def _move_plan(S: int, W: int, M: int, what: str) -> dict:
    cols = 128
    while cols > 32 and 4 * cols * stage_words(W) > STAGE_BYTES:
        cols //= 2
    smem = 4 * cols + 4 * cols * stage_words(W)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{what}: S = {S} rows need {smem} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    return dict(W=W, cols=cols, blocks=-(-M // cols), threads=256, smem=smem)


def permute_plan(S: int, M: int) -> dict:
    """Launch arithmetic of ``permute_state`` at S rows and M columns: W,
    the 32-bit words of a scratch row (the S values, the size and the slot,
    padded to whole 32-byte sectors); ``cols``, the columns of a block's
    transpose tile and gather run (128, 64 or 32: the most whose tile stays
    within STAGE_BYTES, so that several blocks share an SM); the blocks of
    each of the two launches and the shared memory of one (the gather's:
    the int32 order run, then rows of ``stage_words(W)`` words)."""
    return _move_plan(S, -(-(S + 2) // 8) * 8, M, "permute_state")


def rows_plan(S: int, M: int) -> dict:
    """``permute_plan``'s arithmetic for a chain session's row state (W =
    :func:`row_words`): ``to_rows`` runs K2's transpose launch alone,
    ``permute_rows`` its gather launch alone."""
    return _move_plan(S, row_words(S), M, "rows")


def to_rows_plain(values_t, sizes, slots):
    S, M = values_t.shape
    rows = torch.zeros((M, row_words(S)), dtype=torch.int32,
                       device=values_t.device)
    rows[:, :S] = values_t.T.contiguous().view(torch.int32)
    rows[:, S] = sizes
    rows[:, S + 1] = slots
    return rows


def rows_values(rows: torch.Tensor, S: int) -> torch.Tensor:
    """The values of a row state as f32 [S, M] (a view)."""
    return rows.view(torch.float32)[:, :S].T


def to_rows(values_t: torch.Tensor, sizes: torch.Tensor,
            slots: torch.Tensor) -> torch.Tensor:
    """A chain session's row state of its state (values f32 [S, M], rows
    may be strided; sizes, slots int32 [M]): int32 [M, row_words(S)], row m
    column m's values, size and slot, the pads 0. On a card K2's transpose
    launch alone."""
    if not _on_cuda(values_t, sizes, slots):
        return to_rows_plain(values_t, sizes, slots)
    _check(values_t, torch.float32, "values_t", 2)
    _check(sizes, torch.int32, "sizes")
    _check(slots, torch.int32, "slots")
    S, M = values_t.shape
    plan = rows_plan(S, M)
    rows = torch.empty((M, plan["W"]), dtype=torch.int32,
                       device=values_t.device)
    if M:
        _launch("kl_state_rows", values_t.data_ptr(), values_t.stride(0), S,
                M, sizes.data_ptr(), slots.data_ptr(), plan["W"],
                plan["cols"], plan["smem"], rows.data_ptr())
        launches["to_rows"] += 1
    return rows


def permute_rows_plain(rows, S: int, order):
    sel = rows[order.long()]
    return (rows_values(sel, S).contiguous(), sel[:, S].contiguous(),
            sel[:, S + 1].contiguous())


def permute_rows(rows: torch.Tensor, S: int, order: torch.Tensor):
    """A row state (:func:`to_rows`) moved by a permutation back to the
    [S, M] contract: column i of the outputs (values f32 [S, M], sizes,
    slots int32 [M]) is row order[i]. On a card K2's gather launch
    alone."""
    if not _on_cuda(rows, order):
        return permute_rows_plain(rows, S, order)
    _check(rows, torch.int32, "rows", 2)
    _check(order, torch.int32, "order")
    M = order.shape[0]
    if rows.shape[1] != row_words(S) or not rows.is_contiguous():
        raise ValueError(f"permute_rows: rows {tuple(rows.shape)} at S = {S}")
    dev = rows.device
    out = torch.empty((S, M), dtype=torch.float32, device=dev)
    osizes = torch.empty(M, dtype=torch.int32, device=dev)
    oslots = torch.empty(M, dtype=torch.int32, device=dev)
    if M:
        plan = rows_plan(S, M)
        _launch("kl_rows_gather", rows.data_ptr(), S, M, order.data_ptr(),
                plan["W"], plan["cols"], plan["smem"], out.data_ptr(),
                osizes.data_ptr(), oslots.data_ptr())
        launches["permute_rows"] += 1
    return out, osizes, oslots


def permute_state_plain(values_t, sizes, slots, order):
    return values_t[:, order], sizes[order], slots[order]


def permute_state(values_t: torch.Tensor, sizes: torch.Tensor,
                  slots: torch.Tensor, order: torch.Tensor):
    """Move the state by a permutation: column i of the output is column
    order[i] of the input (values f32 [S, M], rows may be strided; order
    int32 [M], the plain version takes any integer type)."""
    if not _on_cuda(values_t, sizes, slots, order):
        return permute_state_plain(values_t, sizes, slots, order)
    _check(values_t, torch.float32, "values_t", 2)
    _check(sizes, torch.int32, "sizes")
    _check(slots, torch.int32, "slots")
    _check(order, torch.int32, "order")
    S, M = values_t.shape
    out = torch.empty((S, M), dtype=torch.float32, device=values_t.device)
    osizes = torch.empty_like(sizes)
    oslots = torch.empty_like(slots)
    if M:
        plan = permute_plan(S, M)
        scratch = torch.empty((M, plan["W"]), dtype=torch.int32,
                              device=values_t.device)
        _launch("kl_permute_state", values_t.data_ptr(), values_t.stride(0),
                S, M, order.data_ptr(), sizes.data_ptr(), slots.data_ptr(),
                plan["W"], plan["cols"], plan["smem"], scratch.data_ptr(),
                out.data_ptr(), osizes.data_ptr(), oslots.data_ptr())
        launches["permute_state"] += 1
    return out, osizes, oslots


# --- K3 + K4: chain collapse and parent fold ----------------------------------

def _shift(x: torch.Tensor, d: int, fill=0) -> torch.Tensor:
    """out[i] = x[i - d] along the last axis, ``fill`` where i < d."""
    pad = torch.full((*x.shape[:-1], d), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :x.shape[-1] - d]], dim=-1)


def _scan_levels(m: int) -> int:
    return min(MAX_CHAIN_LOG, max(m - 1, 1).bit_length())


def _seg_scan(head, w, wv, scs, m: int):
    """Hillis–Steele segmented scan, the reference's order: inclusive
    within-chain sums of w and wv, and the head's slot filled forward."""
    f, W, fill, d = head, w, scs, 1
    for _ in range(_scan_levels(m)):
        keep = ~f
        W = W + torch.where(keep, _shift(W, d), 0)
        wv = wv + torch.where(keep[None, :], _shift(wv, d), 0.0)
        fill = torch.where(f, fill, _shift(fill, d))
        f = f | _shift(f, d, True)
        d *= 2
    return W, wv, fill


def _rev_fill(last, scs, m: int):
    """Every position gets the slot of its chain's last member."""
    f, fill, d = last.flip(0), scs.flip(0), 1
    for _ in range(_scan_levels(m)):
        fill = torch.where(f, fill, _shift(fill, d))
        f = f | _shift(f, d, True)
        d *= 2
    return fill.flip(0)


def chain_plan(S: int, M: int, rows: bool = False) -> dict:
    """Launch arithmetic of ``chain_collapse`` at S rows and M positions:
    ``W``, the words of a scratch row (``permute_plan``'s: the S values,
    the size and the slot in whole 32-byte sectors; with ``rows``, for
    ``chain_collapse_rows``, :func:`row_words`), staged into a row of
    ``row`` = ``stage_words(W)`` words (16-byte aligned, an odd number of
    16-byte pieces: the 16-byte reads of eight neighbouring rows miss no
    bank);
    ``blocks`` blocks, one per sub-range of P positions, P the largest
    power of two in [32, 512] whose P + 2 staged rows (a halo position on
    each side) stay within STAGE_BYTES (P divides 2^15, so no sub-range
    crosses the stride cut; the carries between sub-ranges go by
    look-back, so there is no cluster); ``threads`` = max(P,
    CHAIN_THREADS) a block. ``smem`` follows the kernel's layout
    (csrc/chain_collapse.cu ``kl_chain_words``): the row tile, keys,
    links, sizes as floats, the warp-local size sums, the warps' value
    totals (first the staged rows' sources), their size totals, latest
    heads and masks, the carry's value sums and 8 ints."""
    W = row_words(S) if rows else permute_plan(S, M)["W"]
    row = stage_words(W)
    P = 512
    while P > 32 and 4 * (P + 2) * row > STAGE_BYTES:
        P //= 2
    nw = P // 32
    words = ((P + 2) * row + (P + 2) + (P + 1) + 2 * P
             + max(S * nw, P + 2) + 4 * nw + S + 8)
    if 4 * words > SMEM_LIMIT:
        raise ValueError(f"chain_collapse: S = {S} rows need {4 * words} "
                         f"bytes of shared memory, more than {SMEM_LIMIT}")
    return dict(W=W, row=row, P=P, threads=max(P, CHAIN_THREADS),
                blocks=-(-M // P), smem=4 * words)


def chain_collapse_plain(svals, ssizes, sslots, skey, threshold: float,
                         h: int, smi=None, parent=None, base: int = 0):
    s, m = svals.shape
    starts = segment_starts(skey >> free_bits(h))
    alive = (ssizes > 0) & (skey != BIG_KEY)
    prev = _shift(svals, 1)
    dot = torch.zeros(m, dtype=torch.float32, device=svals.device)
    na = torch.zeros_like(dot)
    nb = torch.zeros_like(dot)
    for i in range(s):
        dot = dot + svals[i] * prev[i]
        na = na + svals[i] * svals[i]
        nb = nb + prev[i] * prev[i]
    nn = torch.sqrt(na * nb)
    sim = dot / torch.where(nn > 0, nn, 1.0)
    pos = torch.arange(m, device=svals.device)
    uncut = (pos & ((1 << MAX_CHAIN_LOG) - 1)) != 0
    link = (alive & _shift(alive, 1, False) & ~starts & uncut
            & (sim >= threshold))
    head = alive & ~link
    is_last = alive & ~torch.cat([link[1:], link.new_zeros(1)])
    W, WV, head_scs = _seg_scan(
        head, ssizes, svals * ssizes.to(torch.float32)[None, :], sslots, m)
    denom = torch.clamp(W, min=1).to(torch.float32)
    new_vt = torch.where(is_last[None, :], WV / denom[None, :], svals)
    new_size = torch.where(is_last, W, torch.where(alive, 0, ssizes))
    last_scs = _rev_fill(is_last, sslots, m)
    new_scs = torch.where(is_last, head_scs,
                          torch.where(head, last_scs, sslots))
    dying = alive & ~is_last
    mi_in = smi if smi is not None else torch.full_like(sslots, -1)
    new_mi = torch.where(dying, head_scs, mi_in)
    if parent is not None:
        parent[new_scs[dying].long() - base] = head_scs[dying]
    return new_vt, new_size, new_scs, new_mi


def chain_collapse(values_t: torch.Tensor, sizes: torch.Tensor,
                   slots: torch.Tensor, order: torch.Tensor,
                   skey: torch.Tensor, threshold: float, h: int,
                   smi: torch.Tensor | None = None,
                   parent: torch.Tensor | None = None, base: int = 0,
                   merged: bool = True):
    """Move the state into the sort order and collapse every chain: the
    state as an iteration holds it (values f32 [S, M], rows may be
    strided; sizes, slots int32 [M]; optional merged_into int32 [M]), K9's
    int32 ``order`` and the sorted combined keys ``skey``. Returns
    (values, sizes, slots, merged_into) in sorted position order, as
    ``permute_state`` then the collapse of the sorted state
    (``chain_collapse_plain``) give them; when ``parent`` (int32, the
    entry of slot s at s − ``base``) is given, each dying slot's parent is
    set to its chain head's slot in place. Every dying slot must lie in
    [base, base + len(parent)): a rank's parent shard holds all of its
    slots. With ``merged`` False, merged_into is None (none is made). On
    a card, two launches: K2's transpose into a profile-major scratch,
    then the collapse, which stages its positions' scratch rows by the
    order; no sorted copy of the state is made."""
    if not _on_cuda(values_t, sizes, slots, order, skey, smi, parent):
        sv, ss, sl = permute_state_plain(values_t, sizes, slots, order)
        out = chain_collapse_plain(sv, ss, sl, skey, threshold, h,
                                   None if smi is None else smi[order],
                                   parent, base)
        return (*out[:3], out[3] if merged else None)
    _check(values_t, torch.float32, "values_t", 2)
    for name, t in (("sizes", sizes), ("slots", slots), ("order", order),
                    ("skey", skey), ("smi", smi), ("parent", parent)):
        if t is not None:
            _check(t, torch.int32, name)
    S, M = values_t.shape
    dev = values_t.device
    out_v = torch.empty((S, M), dtype=torch.float32, device=dev)
    out_size = torch.empty_like(sizes)
    out_slot = torch.empty_like(slots)
    out_mi = torch.empty_like(slots) if merged else None
    if M:
        plan, move = chain_plan(S, M), permute_plan(S, M)
        nsub = plan["blocks"]
        scratch = torch.empty((M, plan["W"]), dtype=torch.int32, device=dev)
        # per sub-range: a published flag (zeroed), then the block counter;
        # its aggregate: head position, head slot, size sum, S value sums
        status = torch.zeros(nsub + 1, dtype=torch.int32, device=dev)
        agg = torch.empty(nsub * (3 + S), dtype=torch.int32, device=dev)
        _launch("kl_chain_collapse", values_t.data_ptr(), values_t.stride(0),
                S, M, order.data_ptr(), sizes.data_ptr(), slots.data_ptr(),
                skey.data_ptr(), _ptr(smi), float(threshold), free_bits(h),
                move["W"], move["cols"], move["smem"], plan["P"],
                plan["threads"], plan["smem"], scratch.data_ptr(),
                status.data_ptr(), agg.data_ptr(), out_v.data_ptr(),
                out_size.data_ptr(), out_slot.data_ptr(), _ptr(out_mi),
                _ptr(parent), int(base))
        launches["chain_collapse"] += 1
    return out_v, out_size, out_slot, out_mi


def chain_collapse_rows_plain(rows, S: int, order, skey, threshold: float,
                              h: int, parent=None, base: int = 0):
    out = chain_collapse_plain(*permute_rows_plain(rows, S, order), skey,
                               threshold, h, None, parent, base)
    return to_rows_plain(*out[:3]), out[1]


def chain_collapse_rows(rows: torch.Tensor, S: int, order: torch.Tensor,
                        skey: torch.Tensor, threshold: float, h: int,
                        parent: torch.Tensor | None = None, base: int = 0):
    """A chain session's iteration of ``chain_collapse`` on its row state:
    rows int32 [M, row_words(S)] (:func:`to_rows`' layout) in input order,
    K9's int32 ``order`` and sorted keys ``skey`` → (the collapsed rows in
    sorted position order, the same layout, the pads as they were; their
    sizes int32 [M] as a column), each row what ``chain_collapse`` gives
    that position's column; ``parent`` and ``base`` as there. No
    merged_into. On a card one launch, which stages its positions' rows by
    the order and writes each block's rows as one contiguous run."""
    if not _on_cuda(rows, order, skey, parent):
        return chain_collapse_rows_plain(rows, S, order, skey, threshold, h,
                                         parent, base)
    _check(rows, torch.int32, "rows", 2)
    for name, t in (("order", order), ("skey", skey), ("parent", parent)):
        if t is not None:
            _check(t, torch.int32, name)
    M, W = rows.shape
    if (W != row_words(S) or not rows.is_contiguous()
            or order.shape[0] != M or skey.shape[0] != M):
        raise ValueError(f"chain_collapse_rows: rows {tuple(rows.shape)} at "
                         f"S = {S}, order {tuple(order.shape)}, skey "
                         f"{tuple(skey.shape)}")
    dev = rows.device
    out = torch.empty_like(rows)
    out_size = torch.empty(M, dtype=torch.int32, device=dev)
    if M:
        plan = chain_plan(S, M, rows=True)
        nsub = plan["blocks"]
        status = torch.zeros(nsub + 1, dtype=torch.int32, device=dev)
        agg = torch.empty(nsub * (3 + S), dtype=torch.int32, device=dev)
        _launch("kl_chain_collapse_rows", rows.data_ptr(), W, S, M,
                order.data_ptr(), skey.data_ptr(), float(threshold),
                free_bits(h), plan["P"], plan["threads"], plan["smem"],
                status.data_ptr(), agg.data_ptr(), out.data_ptr(),
                out_size.data_ptr(), _ptr(parent), int(base))
        launches["chain_collapse"] += 1
    return out, out_size


# --- K5: finalize -------------------------------------------------------------

def finalize_plain(values_t, sizes, slots, parent):
    cap0 = parent.shape[0]
    dev = parent.device
    roots = parent.long()
    while True:
        nxt = roots[roots]
        if torch.equal(nxt, roots):
            break
        roots = nxt
    alive_of_slot = torch.zeros(cap0 + 1, dtype=torch.bool, device=dev)
    alive_of_slot[slots[sizes > 0].long()] = True
    key = torch.where(alive_of_slot[roots], roots, cap0)
    rows = torch.arange(cap0, device=dev)
    first = torch.full((cap0 + 1,), cap0, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, key, rows, "amin")
    count = torch.bincount(key, minlength=cap0 + 1)
    member_key = torch.where(key == cap0, cap0, first[key])
    bits = cap0.bit_length()
    flat = sort_keys_plain(member_key, bits)[1].to(torch.int64)
    cluster_key = torch.where(sizes > 0, first[slots.long()], cap0)
    order = sort_keys_plain(cluster_key, bits)[1]
    alive = sizes[order] > 0
    lens = torch.where(alive, count[slots[order].long()], 0).to(torch.int32)
    csizes = torch.where(alive, sizes[order], 0).to(torch.int64)
    cents = torch.where(alive[:, None], values_t.T[order], 0.0).contiguous()
    return flat, lens, csizes, cents


def finalize(values_t: torch.Tensor, sizes: torch.Tensor,
             slots: torch.Tensor, parent: torch.Tensor):
    """Group rows by the root of their merge forest.

    State columns (values f32 [S, fc], sizes, slots int32 [fc], the slots
    distinct) and the parent forest (int32 [cap0]) → (flat int64 [cap0]:
    member rows, clusters by smallest member, members ascending, rows of
    dead roots last; lens int32 [fc], sizes int64 [fc] and centroids f32
    [fc, S], C-contiguous, in the same cluster order; entries of clusters
    of size 0 are 0): the layouts and types the host returns, so a copy
    is all the pull needs. On the card: csrc/finalize.cu's steps, the two
    stable sorts by :func:`sort_keys` (keys ≤ cap0: cap0.bit_length()
    bits), the columns moved through :func:`permute_state`'s transpose
    launch and a row gather of finalize's own."""
    if not _on_cuda(values_t, sizes, slots, parent):
        return finalize_plain(values_t, sizes, slots, parent)
    _check(values_t, torch.float32, "values_t", 2)
    if not values_t.is_contiguous():
        raise ValueError("values_t must be contiguous")
    for name, t in (("sizes", sizes), ("slots", slots), ("parent", parent)):
        _check(t, torch.int32, name)
    S, fc = values_t.shape
    cap0 = parent.shape[0]
    dev = parent.device
    i32 = dict(dtype=torch.int32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    if cap0 == 0:
        return (torch.empty(0, **i64), torch.zeros(fc, **i32),
                torch.zeros(fc, **i64),
                torch.zeros((fc, S), dtype=torch.float32, device=dev))
    link = torch.empty(cap0, **i32)
    key = torch.empty(cap0, **i32)
    _launch("kl_finalize_roots", cap0, fc, sizes.data_ptr(), slots.data_ptr(),
            parent.data_ptr(), link.data_ptr(), key.data_ptr())
    bits = cap0.bit_length()
    skey, rows = sort_keys(key, bits)
    end = key   # free after the sort: each alive segment's end, by root
    ckey, clen, cstart = (torch.empty(fc, **i32) for _ in range(3))
    _launch("kl_finalize_segments", cap0, fc, skey.data_ptr(),
            rows.data_ptr(), sizes.data_ptr(), slots.data_ptr(),
            link.data_ptr(), end.data_ptr(), ckey.data_ptr(), clen.data_ptr(),
            cstart.data_ptr())
    order = sort_keys(ckey, bits)[1]
    cents = torch.empty((fc, S), dtype=torch.float32, device=dev)
    csizes = torch.empty(fc, **i64)
    lens = torch.empty(fc, **i32)
    if fc:
        plan = permute_plan(S, fc)
        scratch = torch.empty((fc, plan["W"]), **i32)
        _launch("kl_finalize_columns", S, fc, values_t.data_ptr(),
                sizes.data_ptr(), clen.data_ptr(), order.data_ptr(),
                plan["W"], plan["cols"], plan["smem"], scratch.data_ptr(),
                cents.data_ptr(), csizes.data_ptr(), lens.data_ptr())
    sums = torch.empty(max(-(-fc // 1024), 1), **i32)
    flat = torch.empty(cap0, **i64)
    _launch("kl_finalize_place", cap0, fc, order.data_ptr(),
            slots.data_ptr(), cstart.data_ptr(), lens.data_ptr(),
            skey.data_ptr(), rows.data_ptr(), sums.data_ptr(),
            link.data_ptr(), flat.data_ptr())
    launches["finalize"] += 1
    return flat, lens, csizes, cents


# --- K6: t-test and WRS verdicts ----------------------------------------------

def wrs_verdicts_plain(values, sizes, n1: int, n2: int, pval_thresh: float,
                       size_thresh: int):
    _, left, right = ttest.studentttest2(values, n1, n2)
    verdict = ttest.verdicts_of(left, right, sizes, pval_thresh, size_thresh)
    return verdict, left, right


def wrs_plan(N: int, S: int, ld: int, base: int) -> dict:
    """Launch arithmetic of ``wrs_verdicts`` on N rows of S = n1 + n2
    values at a row stride of ``ld`` floats from address ``base``: each
    warp stages 32 rows at a stride of ``chunk`` floats (P, the least P ≥ S
    with P % 8 == 4, so that a lane's float4 reads of its row miss no bank;
    WRS_CHUNK where P is larger, the row then coming in ``chunks`` pieces,
    once for each sum), with copies of ``vec`` bytes (16 where ld and the
    base are 16-byte aligned, else 4), and takes ``tiles`` such tiles (the most, up to WRS_TILES, that
    leave WRS_FILL blocks and, where a SM holds fewer than WRS_MIN_BLOCKS
    blocks, no fewer than at one tile); ``blocks`` of ``threads`` take
    ``tile_rows``
    rows each, with ``smem`` bytes of shared memory (the step table and
    constants, each warp's stage and its rows' sizes, the bucket counts,
    and 15 bytes a row of the block: its x and entry or its tails, its
    bucket and rank, its place in the sorted order, its verdict)."""
    if S < 2 or ld < S:
        raise ValueError(f"wrs_verdicts: S = {S}, ld = {ld}")
    P = S + (4 - S) % 8
    chunk = P if P <= WRS_CHUNK else WRS_CHUNK

    def smem(tiles):
        return (2 * ttest.MAX_ITER * 8 + 64 + WRS_WARPS * 4 * 32 * (chunk + 1)
                + 8 * WRS_BUCKETS + 15 * 32 * WRS_WARPS * tiles)

    def per_sm(tiles):
        return SMEM_SM // (smem(tiles) + 1024)

    tiles = max(1, min(WRS_TILES, N // (32 * WRS_WARPS * WRS_FILL)))
    while tiles > 1 and per_sm(tiles) < min(per_sm(1), WRS_MIN_BLOCKS):
        tiles -= 1
    tile_rows = 32 * WRS_WARPS * tiles
    return dict(chunk=chunk, chunks=-(-S // chunk),
                vec=16 if ld % 4 == 0 and base % 16 == 0 else 4, tiles=tiles,
                threads=32 * WRS_WARPS, tile_rows=tile_rows,
                blocks=-(-N // tile_rows), smem=smem(tiles))


def wrs_verdicts(values: torch.Tensor, sizes: torch.Tensor, n1: int, n2: int,
                 pval_thresh: float, size_thresh: int):
    """Cluster rows (values f32 [N, ≥ n1+n2], group A columns first, each
    row contiguous; sizes int32 [N], N < 2^31) → (verdict int8 [N]: 2 where
    the left tail ≤ p, else 1 where the right tail ≤ p, else 0, and 0 for
    sizes ≤ size_thresh; left and right tails f32 [N])."""
    if not _on_cuda(values, sizes):
        return wrs_verdicts_plain(values, sizes, n1, n2, pval_thresh,
                                  size_thresh)
    _check(values, torch.float32, "values", 2)
    _check(sizes, torch.int32, "sizes")
    N, S = values.shape
    if (n1 < 1 or n2 < 1 or n1 + n2 > S or sizes.shape[0] != N
            or N >= 2**31):
        raise ValueError(f"n1 = {n1}, n2 = {n2} for values {tuple(values.shape)}"
                         f" and sizes {tuple(sizes.shape)}")
    dev = values.device
    verdict = torch.empty(N, dtype=torch.int8, device=dev)
    left = torch.empty(N, dtype=torch.float32, device=dev)
    right = torch.empty(N, dtype=torch.float32, device=dev)
    if N:
        ld = values.stride(0) if N > 1 else S
        plan = wrs_plan(N, n1 + n2, ld, values.data_ptr())
        _launch("kl_wrs_verdicts", values.data_ptr(), ld, N, n1, n2,
                sizes.data_ptr(), 1.0 / n1 + 1.0 / n2, float(pval_thresh),
                min(int(size_thresh), 2**31 - 1), plan["chunk"], plan["vec"],
                plan["tiles"], plan["blocks"], plan["smem"], verdict.data_ptr(),
                left.data_ptr(), right.data_ptr())
        launches["wrs_verdicts"] += 1
    return verdict, left, right


# --- K7: read scorer ------------------------------------------------------------

_SIGN = torch.iinfo(torch.int64).min   # flips the top bit: unsigned order


def _bswap64(v: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(v)
    for i in range(8):
        out |= ((v >> (8 * i)) & 0xFF) << (8 * (7 - i))
    return out


def _reverse_bases64(v: torch.Tensor) -> torch.Tensor:
    m2, m4 = 0x3333333333333333, 0x0F0F0F0F0F0F0F0F
    v = ((v >> 2) & m2) | ((v & m2) << 2)
    v = ((v >> 4) & m4) | ((v & m4) << 4)
    return _bswap64(v)


def score_queries_plain(codes: torch.Tensor, k: int) -> torch.Tensor:
    """The canonical key of every window of the flat code array, with the
    top bit flipped (int64 order is then unsigned order)."""
    nw = max(codes.shape[0] - (k - 1), 0)
    c = codes.to(torch.int64)
    x = torch.zeros(nw, dtype=torch.int64, device=codes.device)
    for j in range(k):
        x |= c[j:j + nw] << (2 * j)
    # revcomp = reverse_bases64(~x) >> (64 − 2k), a logical shift
    rc = (_reverse_bases64(~x) >> (64 - 2 * k)) & ((1 << (2 * k)) - 1)
    return torch.minimum(_bswap64(x) ^ _SIGN, _bswap64(rc) ^ _SIGN)


def score_reads_plain(codes, win_start, n_win, lens, keys, k: int,
                      vote: float):
    """The windows' canonical keys (``score_queries_plain``), a lower-bound
    ``searchsorted`` in the keys with the top bit flipped and per-read hit
    counts as cumulative-sum differences."""
    dev = codes.device
    q = score_queries_plain(codes, k)
    nw = q.shape[0]
    skeys = keys ^ _SIGN
    D = skeys.shape[0]
    if D:
        idx = torch.searchsorted(skeys, q)
        hit = (idx < D) & (skeys[idx.clamp(max=D - 1)] == q)
    else:
        hit = torch.zeros(nw, dtype=torch.bool, device=dev)
    chit = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(hit.to(torch.int64), 0)])
    ws = win_start.to(torch.int64)
    counts = (chit[(ws + n_win).clamp(0, nw)] - chit[ws.clamp(0, nw)])
    denom = torch.clamp(lens - (k - 1), min=1).to(torch.float32)
    ratio = counts.to(torch.float32) / denom
    v = torch.tensor(vote, dtype=torch.float32, device=dev)
    return (lens >= k + 10) & (n_win > 0) & (ratio > v)


def key_directory_bits(n_keys: int) -> int:
    """The prefix bits of the directory of ``n_keys`` keys: about one key
    a bucket, at least 16 and at most 22 (2^22 entries, 16 MB, beside the
    32 MB of 2^22 keys, still fit the card's 50 MB L2)."""
    return min(max((n_keys - 1).bit_length(), 16), 22)


def key_directory_plain(keys: torch.Tensor):
    """The first key whose top ``key_directory_bits(D)`` bits are >= p,
    for p in [0, 2^bits]: a ``searchsorted`` of the keys' unsigned top
    bits."""
    bits = key_directory_bits(keys.shape[0])
    prefix = (keys >> (64 - bits)) & ((1 << bits) - 1)
    at = torch.arange((1 << bits) + 1, dtype=torch.int64, device=keys.device)
    return torch.searchsorted(prefix, at).to(torch.int32)


def key_directory(keys: torch.Tensor):
    """The prefix directory of a differential key set (int64 [D] holding
    unsigned 64-bit keys in unsigned ascending order) → int32 [2^bits + 1]
    at ``key_directory_bits(D)`` bits: entry p is the first key whose top
    bits are >= p, the last entry D. ``score_reads`` searches only between
    entries p and p + 1."""
    if not _on_cuda(keys):
        return key_directory_plain(keys)
    _check(keys, torch.int64, "keys")
    bits = key_directory_bits(keys.shape[0])
    if keys.shape[0] >= 2**31:
        raise ValueError(f"{keys.shape[0]} keys")
    out = torch.empty((1 << bits) + 1, dtype=torch.int32, device=keys.device)
    _launch("kl_key_directory", keys.data_ptr(), keys.shape[0], bits,
            out.data_ptr())
    launches["key_directory"] += 1
    return out


def score_reads(codes: torch.Tensor, win_start: torch.Tensor,
                n_win: torch.Tensor, lens: torch.Tensor, keys: torch.Tensor,
                k: int, vote: float,
                directory: torch.Tensor | None = None) -> torch.Tensor:
    """Score the reads of one part (``ops.reads.pack_part``): codes uint8
    [L], the reads' first windows, window counts and lengths int32 [n],
    and the differential keys as int64 [D] holding unsigned 64-bit keys in
    unsigned ascending order → bool [n], selected reads. Every read's
    windows must lie inside ``codes``: win_start + n_win + k − 1 ≤ L.
    ``directory`` is ``key_directory(keys)``, built here when not given
    (the plain version needs none)."""
    if not _on_cuda(codes, win_start, n_win, lens, keys):
        return score_reads_plain(codes, win_start, n_win, lens, keys, k, vote)
    _check(codes, torch.uint8, "codes")
    for name, t in (("win_start", win_start), ("n_win", n_win),
                    ("lens", lens)):
        _check(t, torch.int32, name)
    _check(keys, torch.int64, "keys")
    n = lens.shape[0]
    if win_start.shape[0] != n or n_win.shape[0] != n:
        raise ValueError("win_start, n_win and lens differ in length")
    if not 1 <= k <= 31:
        raise ValueError(f"k = {k} outside [1, 31]")
    if directory is None:
        directory = key_directory(keys)
    _on_cuda(codes, directory)
    _check(directory, torch.int32, "directory")
    bits = directory.shape[0].bit_length() - 1
    if directory.shape[0] != (1 << bits) + 1:
        raise ValueError(f"a directory of {directory.shape[0]} entries")
    out = torch.empty(n, dtype=torch.uint8, device=codes.device)
    if n:
        _launch("kl_score_reads", codes.data_ptr(), win_start.data_ptr(),
                n_win.data_ptr(), lens.data_ptr(), n, keys.data_ptr(),
                directory.data_ptr(), bits, k, float(vote), out.data_ptr())
        launches["score_reads"] += 1
    return out.view(torch.bool)


# --- K8: the cross-shard exchange -----------------------------------------------

WIN_MAX_CHUNKS = 8192   # chunk offsets one exchange_window gather block scans


def window_plan(c: int) -> dict:
    """Launch arithmetic of ``exchange_window`` at c columns: ``words``
    alive masks of 32 columns; chunks of ``cw`` words (32 · 2^k, the least
    that leaves at most WIN_MAX_CHUNKS chunks: 32 up to 2^23 columns), one
    block of 256 threads a chunk in the first pass; ``nb`` chunks, whose
    offsets every block of the second pass scans in ``smem`` bytes of
    shared memory (one pad word every 32, and the total); ``scratch``, the
    int32 words of the masks of whole chunks and the chunk counts."""
    if c < 1:
        raise ValueError(f"exchange_window: c = {c}")
    words = -(-c // 32)
    cw = 32
    while -(-words // cw) > WIN_MAX_CHUNKS:
        cw *= 2
    nb = -(-words // cw)
    return dict(words=words, cw=cw, nb=nb, smem=4 * (nb + (nb >> 5) + 1),
                scratch=nb * cw + nb)


def exchange_window_plain(values_t, sizes, slots, e: int, rot: int):
    c = sizes.shape[0]
    dev = sizes.device
    ar = torch.cumsum((sizes > 0).to(torch.int32), 0, dtype=torch.int32)
    n_local = ar[-1]
    j = torch.arange(e, dtype=torch.int32, device=dev)
    rank = torch.where(n_local > e, (j + rot * e) % torch.clamp(n_local, min=1),
                       j)
    valid = j < n_local
    pos = torch.where(valid, torch.searchsorted(ar, rank + 1).to(torch.int32),
                      c)
    posc = torch.clamp(pos, max=c - 1).long()
    w_sizes = torch.where(valid, sizes[posc], 0)
    w_slots = torch.where(valid, slots[posc], -1)
    return pos, values_t[:, posc], w_sizes, w_slots


def exchange_window(values_t: torch.Tensor, sizes: torch.Tensor,
                    slots: torch.Tensor, e: int, rot: int):
    """The rotating exchange window of one rank's state (values f32 [S, c],
    rows may be strided; sizes, slots int32 [c], c ≥ 1): entry j is the
    alive column of alive-rank (j + rot·e) mod n_local in position order
    (j itself when n_local ≤ e). Returns (pos int32 [e], c for padding;
    values f32 [S, e]; sizes int32 [e], 0 for padding; slots int32 [e], -1
    for padding)."""
    if not _on_cuda(values_t, sizes, slots):
        return exchange_window_plain(values_t, sizes, slots, e, rot)
    _check(values_t, torch.float32, "values_t", 2)
    _check(sizes, torch.int32, "sizes")
    _check(slots, torch.int32, "slots")
    S, c = values_t.shape
    if c < 1 or e < 1 or sizes.shape[0] != c or slots.shape[0] != c:
        raise ValueError(f"exchange_window: c = {c}, e = {e}, sizes "
                         f"{tuple(sizes.shape)}, slots {tuple(slots.shape)}")
    plan = window_plan(c)
    dev = values_t.device
    i32 = dict(dtype=torch.int32, device=dev)
    scratch = torch.empty(plan["scratch"], **i32)   # masks, chunk counts
    pos = torch.empty(e, **i32)
    w_vals = torch.empty((S, e), dtype=torch.float32, device=dev)
    w_sizes = torch.empty(e, **i32)
    w_slots = torch.empty(e, **i32)
    _launch("kl_exchange_window", values_t.data_ptr(), values_t.stride(0), S,
            c, sizes.data_ptr(), slots.data_ptr(), e, int(rot), plan["cw"],
            scratch.data_ptr(), pos.data_ptr(), w_vals.data_ptr(),
            w_sizes.data_ptr(), w_slots.data_ptr())
    launches["exchange_window"] += 1
    return pos, w_vals, w_sizes, w_slots


def exchange_fold_plain(m_vals, m_sizes, m_mi, m_scs, w_slots, pos, values_t,
                        sizes, parent, base: int):
    c0_loc, c = parent.shape[0], sizes.shape[0]
    gi = m_scs.long() - base
    mine = (m_scs >= 0) & (gi >= 0) & (gi < c0_loc)
    inv = torch.full((c0_loc,), -1, dtype=torch.int64, device=parent.device)
    inv[gi[mine]] = torch.arange(m_scs.shape[0],
                                 device=parent.device)[mine]
    wi = w_slots.long() - base
    keep = (pos < c) & (w_slots >= 0) & (wi >= 0) & (wi < c0_loc)
    dst, p = wi[keep], pos[keep].long()
    q = inv[dst]
    r_mi = m_mi[q]
    parent[dst[r_mi >= 0]] = r_mi[r_mi >= 0]
    sizes[p] = m_sizes[q]
    values_t[:, p] = m_vals[:, q]


def exchange_fold(m_vals: torch.Tensor, m_sizes: torch.Tensor,
                  m_mi: torch.Tensor, m_scs: torch.Tensor,
                  w_slots: torch.Tensor, pos: torch.Tensor,
                  values_t: torch.Tensor, sizes: torch.Tensor,
                  parent: torch.Tensor, base: int) -> None:
    """Fold one exchange's global phase back into this rank's state, in
    place.

    The global phase's result in its sorted positions (values f32 [S, n]
    contiguous; sizes, merged_into, slots int32 [n]), this rank's window
    (slots int32 [e] and pos int32 [e] from :func:`exchange_window`), the
    state after the local phase (values f32 [S, c] with contiguous rows,
    sizes int32 [c]) and the parent shard (int32 [c0_loc], slot ``base +
    i`` at i). Sets parent[slot − base] for every global merge of this
    rank's slots, and writes each window entry's merged size and values
    over its column ``pos``; padding entries (pos = c) and other ranks'
    slots are dropped. The local phase's merges are folded by
    :func:`chain_collapse` with the same parent shard and base.
    """
    if not _on_cuda(m_vals, m_sizes, m_mi, m_scs, w_slots, pos, values_t,
                    sizes, parent):
        exchange_fold_plain(m_vals, m_sizes, m_mi, m_scs, w_slots, pos,
                            values_t, sizes, parent, base)
        return
    _check(m_vals, torch.float32, "m_vals", 2)
    _check(values_t, torch.float32, "values_t", 2)
    if not m_vals.is_contiguous():
        raise ValueError("m_vals must be contiguous")
    for name, t in (("m_sizes", m_sizes), ("m_mi", m_mi), ("m_scs", m_scs),
                    ("w_slots", w_slots), ("pos", pos), ("sizes", sizes),
                    ("parent", parent)):
        _check(t, torch.int32, name)
    S, n = m_vals.shape
    c, e = values_t.shape[1], w_slots.shape[0]
    if (values_t.shape[0] != S or pos.shape[0] != e or sizes.shape[0] != c
            or any(t.shape[0] != n for t in (m_sizes, m_mi, m_scs))):
        raise ValueError("exchange_fold: inconsistent shapes")
    c0_loc = parent.shape[0]
    inv = torch.empty(c0_loc, dtype=torch.int32, device=parent.device)
    _launch("kl_exchange_fold", m_vals.data_ptr(), S, n, m_sizes.data_ptr(),
            m_mi.data_ptr(), m_scs.data_ptr(), w_slots.data_ptr(),
            pos.data_ptr(), e, values_t.data_ptr(), values_t.stride(0), c,
            sizes.data_ptr(), parent.data_ptr(), int(base), c0_loc,
            inv.data_ptr())
    launches["exchange_fold"] += 1


# --- K10: pairing-merge rounds ----------------------------------------------------

def pairing_capacity(S: int) -> int:
    """K10's capacity C at S samples: the most positions (a multiple of
    32, at most PAIR_CAP_MAX) a window may hold so that a block's range of
    up to 2C - 1 positions, staged at 4S + 11 bytes a position (values,
    size, key, half a packed pair, flags) in 2C + 4 places, fits
    PAIR_PER_SM blocks on a SM, else one; 0 where not even 32 positions
    fit one block."""
    per = 4 * S + 11
    for budget in (SMEM_SM // PAIR_PER_SM - 1024 - PAIR_STATIC,
                   SMEM_LIMIT - PAIR_STATIC):
        C = min(PAIR_CAP_MAX, (budget // per - 4) // 2 // 32 * 32)
        if C >= 32:
            return C
    return 0


def pairing_plan(S: int, M: int) -> dict:
    """Launch arithmetic of ``pairing_rounds`` at S samples and M
    positions. Launch (1): ``blocks`` windows of ``C`` positions
    (:func:`pairing_capacity`; one block at C = 0), ``threads`` threads and
    ``smem`` bytes a block. Launch (2): one cooperative launch of
    ``long_threads`` threads a block on ``long_tile`` positions a tile.
    ``scratch``: int32 entries (the list's count, each window's first
    start, the long segments' starts, ends, tiles and tile bases, the
    cooperative blocks' and the tiles' aggregates). ``launches``: kernel
    launches a call. Positions are int32."""
    if S < 0 or not 0 <= M <= PAIR_M_MAX:
        raise ValueError(f"pairing_rounds: S = {S}, {M} positions")
    C = pairing_capacity(S)
    blocks = -(-M // C) if C else 1
    long_tile = PAIR_LONG_THREADS * PAIR_LONG_ITEMS
    tiles = -(-M // long_tile) + blocks
    return dict(C=C, threads=PAIR_THREADS, blocks=blocks,
                smem=(2 * C + 4) * (4 * S + 11) if C else 0,
                long_threads=PAIR_LONG_THREADS, long_tile=long_tile,
                scratch=2 + 5 * blocks + 3 * PAIR_LONG_GRID_MAX + 3 * tiles,
                launches=2)


def pairing_rounds_plain(svals, ssizes, sslots, skey, shift: int,
                         threshold: float, rounds: int, smi=None,
                         parent=None, base: int = 0, stats=None):
    """The reference's rounds (kmerlsh_tpu/cluster/engine.py:220-270),
    computed by the right-role elements: a left's pair is its right's, and
    both sides sum their cosine in the same order. ``stats``, a list, gets
    (pairs formed, pairs merged) for each round."""
    s, m = svals.shape
    dev = svals.device
    mi = smi if smi is not None else torch.full(
        (m,), -1, dtype=torch.int32, device=dev)
    starts = segment_starts(skey >> shift)
    valid = skey != BIG_KEY
    pos = torch.arange(m, device=dev)
    for r in range(rounds):
        alive = (ssizes > 0) & valid
        rank = alive_rank_in_segment(alive, starts)
        prev = torch.cummax(torch.where(alive, pos, -1), 0).values
        prev_before = torch.cat([prev.new_full((1,), -1), prev[:-1]])
        ph = r % 2
        right = alive & (rank >= ph + 1) & ((rank - ph) % 2 == 1)
        p = torch.nonzero(right).squeeze(1)
        q = prev_before[p]
        dot = torch.zeros(p.shape[0], dtype=torch.float32, device=dev)
        nr = torch.zeros_like(dot)
        nl = torch.zeros_like(dot)
        for i in range(s):
            vr, vl = svals[i, p], svals[i, q]
            dot = dot + vr * vl
            nr = nr + vr * vr
            nl = nl + vl * vl
        nn = torch.sqrt(nr * nl)
        merge = dot / torch.where(nn > 0, nn, 1.0) >= threshold
        if stats is not None:
            stats.append((p.shape[0], int(merge.sum())))
        p, q = p[merge], q[merge]
        sr, sl = ssizes[p], ssizes[q]
        svals[:, q] = ((svals[:, q] * sl.to(torch.float32)
                        + svals[:, p] * sr.to(torch.float32))
                       / (sl + sr).to(torch.float32))
        ssizes[q] = sl + sr
        ssizes[p] = 0
        mi[p] = sslots[q]
        if parent is not None:
            parent[sslots[p].long() - base] = sslots[q]
    return svals, ssizes, mi


def pairing_rounds(svals: torch.Tensor, ssizes: torch.Tensor,
                   sslots: torch.Tensor, skey: torch.Tensor, shift: int,
                   threshold: float, rounds: int,
                   smi: torch.Tensor | None = None,
                   parent: torch.Tensor | None = None, base: int = 0):
    """``rounds`` pairing-merge rounds over the sorted state, IN PLACE:
    values f32 [S, M] contiguous, sizes int32 [M] and merged_into int32
    [M] (allocated at -1 when ``smi`` is None) are updated; slots and keys
    (int32 [M]) are read. Segments are runs of equal ``skey >> shift``
    (``free_bits(h)`` on combined keys, 0 on bucket keys); a column is
    alive where its size is positive and its key not BIG_KEY. Returns
    (values, sizes, merged_into). When ``parent`` (int32, the entry of slot
    s at s − ``base``) is given, each dying slot's parent is set to its
    absorber's slot in place."""
    if rounds < 0 or not 0 <= shift <= 30:
        raise ValueError(f"pairing_rounds: rounds = {rounds}, shift = {shift}")
    if not _on_cuda(svals, ssizes, sslots, skey, smi, parent):
        return pairing_rounds_plain(svals, ssizes, sslots, skey, shift,
                                    threshold, rounds, smi, parent, base)
    _check(svals, torch.float32, "svals", 2)
    if not svals.is_contiguous():
        raise ValueError("svals must be contiguous")
    S, M = svals.shape
    for name, t in (("ssizes", ssizes), ("sslots", sslots), ("skey", skey),
                    ("smi", smi), ("parent", parent)):
        if t is not None:
            _check(t, torch.int32, name)
            if name != "parent" and t.shape[0] != M:
                raise ValueError(f"{name}: want {M} entries, got {t.shape[0]}")
    mi = smi if smi is not None else torch.full(
        (M,), -1, dtype=torch.int32, device=svals.device)
    if M and rounds:
        plan = pairing_plan(S, M)
        scratch = torch.empty(plan["scratch"], dtype=torch.int32,
                              device=svals.device)
        _launch("kl_pairing_rounds", svals.data_ptr(), S, M,
                ssizes.data_ptr(), sslots.data_ptr(), skey.data_ptr(),
                mi.data_ptr(), _ptr(parent), int(base), shift,
                float(threshold), rounds, plan["C"], plan["blocks"],
                plan["smem"], scratch.data_ptr(), plan["scratch"])
        launches["pairing_rounds"] += 1
        card_launches["pairing_rounds"] += plan["launches"]
    return svals, ssizes, mi


# --- the hyperplanes' draw ------------------------------------------------------

def draw_planes(seed: int, iterations: int, S: int, device) -> torch.Tensor:
    """f32 [iterations, S, H_MAX + 1] on ``device``, slice ``it`` bit for bit
    ``rng.draw_hyperplanes(seed, it, S)``: on the CPU the plain twin
    ``rng.draw_planes``, on a card one launch on the current stream."""
    rng.PRNGKey(seed)                  # refuses a seed outside [0, 2^32)
    if iterations < 0 or S < 0:
        raise ValueError(f"draw_planes: {iterations} iterations of {S} rows")
    dev = torch.device(device)
    if dev.type == "cpu":
        return rng.draw_planes(seed, iterations, S)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    out = torch.empty((iterations, S, lsh.H_MAX + 1), dtype=torch.float32,
                      device=dev)
    if out.numel():
        with torch.cuda.device(dev):
            _launch("kl_draw_planes", seed, iterations, S, out.data_ptr())
        launches["draw_planes"] += 1
    return out


def normal_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """The normals ``draw_planes`` makes of given random words (int32
    holding uint32): on a card its device function alone, so that a test
    can feed it every mantissa; on the CPU ``rng.normal_of_bits``."""
    if not _on_cuda(bits):
        return rng.normal_of_bits(bits.to(torch.int64) & 0xFFFFFFFF)
    _check(bits, torch.int32, "bits")
    out = torch.empty(bits.shape, dtype=torch.float32, device=bits.device)
    if bits.numel():
        _launch("kl_normal_of_bits", bits.data_ptr(), bits.numel(),
                out.data_ptr())
    return out
