"""K8's arithmetic on the CPU: the window lookup of csrc/exchange.cu
(kl_win_masks, kl_win_gather) transcribed into numpy against
exchange_window_plain, and the split of the sharded fold (the local merges
folded by chain_collapse with a base, then exchange_fold) against the
composition it replaces (chain_collapse without a parent, then the fold of
both the local and the global merges)."""

import numpy as np
import pytest
import torch

from kmerlsh_tpu_torch import kernels, testdata
from kmerlsh_tpu_torch.cluster import engine
from kmerlsh_tpu_torch.ops import rng

# --- K8a: masks, chunk offsets, a search of the offsets, select in a mask ---


def _select(m: int, k: int) -> int:
    """kl_select: the bit position of the k-th set bit of m, five steps."""
    p = 0
    for width in (16, 8, 4, 2):
        n = bin(m & ((1 << width) - 1)).count("1")
        if k >= n:
            k -= n
            p += width
            m >>= width
    return p + (1 if k >= (m & 1) else 0)


def _window_steps(sizes: np.ndarray, e: int, rot: int, cw: int):
    """kl_win_masks and kl_win_gather's lookup in numpy: (pos int32 [e], the
    number of chunks). Chunk b holds mask words [b·cw, (b+1)·cw); an entry's
    chunk is the largest b whose exclusive offset is at most its rank; the
    chunk is read 32 words at a time, and the entry takes the first word
    whose inclusive popcount exceeds its rank in the group (a five-step
    search over the 32 lanes), then the select inside it."""
    c = len(sizes)
    words = -(-c // 32)
    nb = -(-words // cw)
    alive = np.zeros(nb * cw * 32, bool)
    alive[:c] = sizes > 0
    bits = alive.reshape(-1, 32).astype(np.int64) << np.arange(32)
    masks = bits.sum(1)
    popc = alive.reshape(-1, 32).sum(1)
    counts = popc.reshape(nb, cw).sum(1)
    offs = np.concatenate([[0], np.cumsum(counts)])
    n_local = int(offs[-1])
    pos = np.full(e, c, np.int64)
    for j in range(min(e, n_local)):
        rank = (j + rot * e) % n_local if n_local > e else j
        lo, hi = 0, nb - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if offs[mid] <= rank:
                lo = mid
            else:
                hi = mid - 1
        rem = rank - offs[lo]
        for g in range(0, cw, 32):
            w0 = lo * cw + g
            inc = np.cumsum(popc[w0:w0 + 32])
            if rem < inc[-1]:
                w = 0
                for step in (16, 8, 4, 2, 1):
                    if inc[w + step - 1] <= rem:
                        w += step
                before = inc[w] - popc[w0 + w]
                pos[j] = (w0 + w) * 32 + _select(int(masks[w0 + w]),
                                                 int(rem - before))
                break
            rem -= inc[-1]
    return pos.astype(np.int32), nb


WINDOW_SHAPES = [(20, 8), (5000, 256), (70001, 1024)]   # (c, e)


@pytest.mark.parametrize("cw", [32, 64])
@pytest.mark.parametrize("rot", [0, 5])
@pytest.mark.parametrize("alive", ["none", "below", "equal", "above"])
@pytest.mark.parametrize("c,e", WINDOW_SHAPES)
def test_window_lookup_gives_the_plain_window(c, e, alive, rot, cw):
    """n_local 0, below, equal to and above e; c below 32 and no multiple of
    1024; one and two groups of 32 words a chunk."""
    n_alive = {"none": 0, "below": e // 2, "equal": e,
               "above": min(3 * e, c)}[alive]
    r = np.random.default_rng(c + n_alive + rot)
    sizes = np.zeros(c, np.int32)
    sizes[r.choice(c, size=n_alive, replace=False)] = r.integers(
        1, 9, size=n_alive)
    slots = r.permutation(c).astype(np.int32)
    vals = r.normal(size=(3, c)).astype(np.float32)
    pos, nb = _window_steps(sizes, e, rot, cw)
    want = kernels.exchange_window_plain(
        torch.from_numpy(vals), torch.from_numpy(sizes),
        torch.from_numpy(slots), e, rot)
    assert np.array_equal(pos, want[0].numpy())
    assert int((pos < c).sum()) == min(n_alive, e)
    if c > 32 * cw:
        assert nb > 1


# --- K8b: the fold split between K3 and the exchange fold ------------------

def _old_fold(m_vals, m_sizes, m_mi, m_scs, w_slots, pos, values_t, sizes,
              slots, mi, parent, base):
    """The exchange fold before the split: the local phase's merges
    (parent[slot − base] = merged_into) and then the global ones."""
    c0_loc, c = parent.shape[0], sizes.shape[0]
    li = slots.long() - base
    ok = (mi >= 0) & (li >= 0) & (li < c0_loc)
    parent[li[ok]] = mi[ok]
    gi = m_scs.long() - base
    mine = (m_scs >= 0) & (gi >= 0) & (gi < c0_loc)
    inv = torch.full((c0_loc,), -1, dtype=torch.int64)
    inv[gi[mine]] = torch.arange(m_scs.shape[0])[mine]
    wi = w_slots.long() - base
    keep = (pos < c) & (w_slots >= 0) & (wi >= 0) & (wi < c0_loc)
    dst, p = wi[keep], pos[keep].long()
    q = inv[dst]
    r_mi = m_mi[q]
    parent[dst[r_mi >= 0]] = r_mi[r_mi >= 0]
    sizes[p] = m_sizes[q]
    values_t[:, p] = m_vals[:, q]


def _sorted_shard(c: int, S: int = 8, seed: int = 0):
    """A sorted local state as the sharded local phase sees it: values with
    the distribution of bench.py make_data (rows drawn from a profile pool
    plus noise), one column in 20 dead, keys at the data's h."""
    r = np.random.default_rng(seed)
    pool = testdata.profile_pool(r, max(16, c >> 5), S)
    vals = (pool[r.integers(0, len(pool), size=c)]
            + 0.01 * r.normal(size=(c, S))).T.astype(np.float32)
    sizes = (r.random(c) >= 0.05).astype(np.int32)
    values_t, sz = torch.from_numpy(np.ascontiguousarray(vals)), \
        torch.from_numpy(sizes)
    h = engine._active_h_of(int(sizes.sum()))
    key, _ = kernels.lsh_keys(values_t, sz, rng.draw_hyperplanes(
        seed, 0, S), h)
    skey, order = torch.sort(key, stable=True)
    slots = torch.arange(c, dtype=torch.int32)
    return (*kernels.permute_state(values_t, sz, slots, order), skey), h


@pytest.mark.parametrize("rank", [0, 3])
def test_fold_in_chain_collapse_equals_the_old_composition(rank):
    """World 4: chain_collapse_plain(…, parent, base) and then the new
    exchange_fold_plain leave the parent shard, sizes and values that
    chain_collapse_plain without a parent and then the old fold left."""
    c, e, thr = 4096, 256, 0.95
    (sv, ss, sl, skey), h = _sorted_shard(c)
    local = kernels.chain_collapse_plain(sv, ss, sl, skey, thr, h)
    (*glob, w_slots, pos, lv, ls, lsl, lmi, parent,
     base) = testdata.exchange_inputs(*local, 4, rank, e)
    assert base == rank * c
    assert int((lmi >= 0).sum()) > 0 and int((glob[2] >= 0).sum()) > 0

    old_v, old_s, old_p = lv.clone(), ls.clone(), parent.clone()
    _old_fold(*glob, w_slots, pos, old_v, old_s, lsl, lmi, old_p, base)

    new_p = parent.clone()
    nv, ns, nsl, nmi = kernels.chain_collapse_plain(sv, ss, sl + base, skey,
                                                    thr, h, None, new_p,
                                                    base)
    for a, b in ((nv, lv), (ns, ls), (nsl, lsl), (nmi, lmi)):
        assert torch.equal(a, b)
    kernels.exchange_fold_plain(*glob, w_slots, pos, nv, ns, new_p, base)
    assert torch.equal(new_p, old_p)
    assert torch.equal(ns, old_s)
    assert torch.equal(nv, old_v)
    # both folds wrote: local merges and global ones
    assert int((new_p != parent).sum()) > int((lmi >= 0).sum())


@pytest.mark.parametrize("base", [0, 1000])
def test_chain_collapse_plain_folds_at_a_base(base):
    """The parent entry of slot s lies at s − base: a shard of the slots
    [base, base + c) folds as the whole forest's slice does."""
    c = 2048
    (sv, ss, sl, skey), h = _sorted_shard(c, seed=1)
    forest = torch.arange(base + c, dtype=torch.int32)
    shard = forest[base:].clone()
    a = kernels.chain_collapse_plain(sv, ss, sl + base, skey, 0.95, h, None,
                                     forest)
    b = kernels.chain_collapse_plain(sv, ss, sl + base, skey, 0.95, h, None,
                                     shard, base)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(forest[base:], shard)
    assert torch.equal(forest[:base], torch.arange(base, dtype=torch.int32))
    assert int((shard != torch.arange(base, base + c,
                                      dtype=torch.int32)).sum()) > 0
