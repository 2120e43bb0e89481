# Copy of kmerlsh_tpu/cluster/groups.py; only its imports of this package changed.
"""CSR-packed ragged id lists — the scalable representation of cluster
membership.

The reference materializes every cluster's member ids as an individual
``std::vector<uint64_t>`` inside ``Core::Abundance`` (common/abundance.h:21)
and writes them one ``<<`` at a time (io/ioMatrix.cc:265-294). At the
design-point scale (1e8 rows, 1e6+ clusters) any per-cluster Python object
or per-id format call dominates total wall-clock, so the framework keeps
membership as ONE flat id array plus offsets and does every per-cluster
operation (ordering, filtering, regrouping, rendering) as vectorized NumPy.

:class:`Groups` quacks like ``list[np.ndarray]`` (len / index / iterate —
each group a zero-copy view), so existing callers and tests keep working.
"""

from __future__ import annotations

import numpy as np


class Groups:
    """Ragged list of id arrays in CSR form: group ``i`` is
    ``flat[offsets[i]:offsets[i+1]]``."""

    __slots__ = ("flat", "offsets")

    def __init__(self, flat: np.ndarray, offsets: np.ndarray):
        self.flat = np.asarray(flat)
        self.offsets = np.asarray(offsets, dtype=np.int64)

    @classmethod
    def from_list(cls, lst, dtype=np.int64) -> "Groups":
        sizes = np.fromiter((len(g) for g in lst), count=len(lst),
                            dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        flat = (np.concatenate([np.asarray(g) for g in lst]).astype(
            dtype, copy=False) if len(lst) else np.empty(0, dtype))
        return cls(flat, offsets)

    @property
    def sizes(self) -> np.ndarray:
        return np.diff(self.offsets)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            if i < 0:
                i += len(self)
            return self.flat[self.offsets[i]:self.offsets[i + 1]]
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step != 1:
                return Groups.from_list(
                    [self[j] for j in range(start, stop, step)],
                    dtype=self.flat.dtype)
            lo, hi = self.offsets[start], self.offsets[stop]
            return Groups(self.flat[lo:hi],
                          self.offsets[start:stop + 1] - lo)
        raise TypeError(f"Groups index must be an int or slice, got {type(i)}")

    def __iter__(self):
        for i in range(len(self)):
            yield self.flat[self.offsets[i]:self.offsets[i + 1]]

    def map_ids(self, table: np.ndarray) -> "Groups":
        """Element-wise id translation through ``table`` (within-group order
        is preserved — callers pass monotone tables when sortedness must
        survive)."""
        return Groups(table[self.flat], self.offsets)

    def select(self, idx: np.ndarray) -> "Groups":
        """Gather groups (by index array or bool mask) into a new CSR."""
        idx = np.asarray(idx)
        if idx.dtype == bool:
            idx = np.flatnonzero(idx)
        lens = self.sizes[idx]
        offs = np.concatenate([[0], np.cumsum(lens)])
        n = int(offs[-1])
        pos = (np.repeat(self.offsets[:-1][idx] - offs[:-1], lens)
               + np.arange(n))
        return Groups(self.flat[pos], offs)

    def regroup(self, assignment: "Groups | list") -> "Groups":
        """Concatenate groups of ``self`` according to ``assignment`` (whose
        ids index self's groups), sorting ids ascending within each output
        group — the vectorized twin of the reference's id concat on merge
        (funcAB.cc:55-60) + the final per-line ascending order."""
        a = assignment if isinstance(assignment, Groups) \
            else Groups.from_list(assignment)
        merged = self.select(a.flat.astype(np.int64))
        # merged group g spans assignment group j's sub-groups; rebuild the
        # outer offsets by summing member counts per assignment group
        inner = merged.sizes
        out_sizes = np.add.reduceat(
            np.concatenate([inner, [0]]),
            np.minimum(a.offsets[:-1], len(inner)))
        out_sizes[a.sizes == 0] = 0
        offs = np.concatenate([[0], np.cumsum(out_sizes)])
        gid = np.repeat(np.arange(len(a), dtype=np.int64), out_sizes)
        order = np.lexsort((merged.flat, gid))
        return Groups(merged.flat[order], offs)

    def astype(self, dtype) -> "Groups":
        return Groups(self.flat.astype(dtype, copy=False), self.offsets)


def as_groups(ids_list) -> Groups:
    return ids_list if isinstance(ids_list, Groups) \
        else Groups.from_list(ids_list)
