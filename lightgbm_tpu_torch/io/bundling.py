"""Exclusive feature bundling: sparse columns share stored bin slots.

Port of lightgbm_tpu/io/bundling.py (BundlePlan :32, plan_bundles :65,
build_stored_matrix :196, expansion_maps :223); host numpy, as there.
Reference capability replaced: the sparse bin storage of
src/io/sparse_bin.hpp:17-331, auto-selected at sparse_rate >= 0.8
(src/io/bin.cpp:291-302).

Mutually exclusive sparse features share one stored row (a slot):
member i's nonzero bins 1..nb_i-1 occupy the slot range
[off_i+1, off_i+nb_i-1], and slot bin 0 means "every member at its zero
bin". A one-hot-heavy table collapses to a few stored rows, so the
histogram kernels stream S slot rows instead of F feature rows.

Training stays exact for conflict-free bundles: the (S, B, 3) stored
histogram expands to per-feature histograms by gathers (member ranges)
plus a subtraction for bin 0 (slot total minus member range), and the
split scan and the model see only the original feature ids
(models/tree_learner.py). Rows that break exclusivity (conflicts, only
with max_conflict_rate > 0) keep the first member's bin; planning runs
on the binning sample and conflicts are counted and logged in the full
pass.
"""

import numpy as np

from ..utils.log import Log

SPARSE_THRESHOLD = 0.8   # bin.cpp:291-302 auto-sparse threshold
MAX_SLOT_BINS = 256      # a slot's histogram fits one uint8 bin tile


class BundlePlan:
    """Stored slot and bin offset per virtual feature. `conflict_rate`
    is the max_conflict_rate the plan was built with, so a binary cache
    holding a tolerant plan is not reused by an exact-bundling config."""

    def __init__(self, feat_slot, feat_offset, slot_bins, num_slots,
                 conflict_rate=0.0):
        self.feat_slot = np.asarray(feat_slot, dtype=np.int32)      # (F,)
        self.feat_offset = np.asarray(feat_offset, dtype=np.int32)  # (F,)
        self.slot_bins = np.asarray(slot_bins, dtype=np.int32)      # (S,)
        self.num_slots = int(num_slots)
        self.conflict_rate = float(conflict_rate)

    @property
    def is_identity(self):
        return self.num_slots == len(self.feat_slot) and \
            bool((self.feat_offset == 0).all())

    def to_dict(self):
        return {"feat_slot": self.feat_slot, "feat_offset": self.feat_offset,
                "slot_bins": self.slot_bins,
                "num_slots": np.asarray(self.num_slots),
                "conflict_rate": np.asarray(self.conflict_rate)}

    @classmethod
    def from_dict(cls, d):
        return cls(d["feat_slot"], d["feat_offset"], d["slot_bins"],
                   int(d["num_slots"]),
                   float(d.get("conflict_rate", 0.0)))


def plan_bundles(mappers, sample_bins, enable=True, max_conflict_rate=0.0):
    """Greedy first-fit bundling on the binning sample.

    Args:
      mappers: per (used) feature BinMapper.
      sample_bins: (F, S_rows) int bins of the sample rows, or a
        callable j -> (S_rows,) bins, so a wide sparse dataset plans
        one column at a time.
      enable: config is_enable_sparse.
      max_conflict_rate: fraction of sample rows a bundle may hold in
        conflict; 0.0 bundles only perfectly exclusive features.

    Returns a BundlePlan (identity when nothing bundles).
    """
    f = len(mappers)
    col_bins = sample_bins if callable(sample_bins) \
        else (lambda j: sample_bins[j])
    identity = BundlePlan(np.arange(f), np.zeros(f, np.int32),
                          [m.num_bin for m in mappers], f)
    if not enable or f == 0:
        return identity

    # numerical, zero maps to bin 0, genuinely sparse
    candidates = [j for j, m in enumerate(mappers)
                  if m.bin_type == 0 and m.sparse_rate >= SPARSE_THRESHOLD
                  and int(m.value_to_bin(np.zeros(1))[0]) == 0]
    if len(candidates) < 2:
        return identity

    nnz = {j: np.count_nonzero(col_bins(j)) for j in candidates}
    order = sorted(candidates, key=lambda j: -nnz[j])
    # First fit with a signature prefilter: occupancy is bit-packed and
    # its first sig_len bytes are a per-bundle signature. A signature
    # hit is a real conflict on those rows, so one (B, sig_len) AND
    # prunes most bundles and the exact packed check runs on the
    # survivors only.
    cnt = len(col_bins(order[0]))
    sig_len = min(64, (cnt + 7) // 8)
    cap = MAX_SLOT_BINS - 1
    budget = int(max_conflict_rate * cnt)
    max_b = len(order)
    sig_mat = np.zeros((max_b, sig_len), np.uint8)
    used_arr = np.zeros(max_b, np.int64)
    conf_arr = np.zeros(max_b, np.int64)   # conflicts accrued per bundle
    occ = []         # per-bundle packed occupancy, (cnt/8,) uint8
    members_l = []   # per-bundle member lists
    popcount = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                             axis=1).sum(axis=1).astype(np.int64)
    for j in order:
        cp = np.packbits(col_bins(j) > 0)
        csig = cp[:sig_len]
        nb = mappers[j].num_bin
        b = len(occ)
        placed = -1
        if b and budget == 0:
            # exact mode: any signature overlap is a conflict
            viable = ~((sig_mat[:b] & csig).any(axis=1)) \
                & (used_arr[:b] + (nb - 1) <= cap)
            for idx in np.flatnonzero(viable):
                if not (occ[idx] & cp).any():
                    placed = int(idx)
                    break
        elif b:
            # tolerant mode: the signature overlap's popcount is a lower
            # bound on the real overlap
            sig_lb = popcount[sig_mat[:b] & csig].sum(axis=1)
            viable = (conf_arr[:b] + sig_lb <= budget) \
                & (used_arr[:b] + (nb - 1) <= cap)
            for idx in np.flatnonzero(viable):
                overlap = int(popcount[occ[idx] & cp].sum())
                if conf_arr[idx] + overlap <= budget:
                    placed = int(idx)
                    conf_arr[idx] += overlap
                    break
        if placed >= 0:
            members_l[placed].append(j)
            occ[placed] |= cp
            sig_mat[placed] |= csig
            used_arr[placed] += nb - 1
        else:
            members_l.append([j])
            occ.append(cp)
            sig_mat[b] = csig
            used_arr[b] = nb - 1

    bundles = [m for m in members_l if len(m) >= 2]
    if not bundles:
        return identity

    bundled = set()
    feat_slot = np.zeros(f, np.int32)
    feat_offset = np.zeros(f, np.int32)
    slot_bins = []
    for slot_id, members in enumerate(bundles):
        off = 0
        for j in members:
            bundled.add(j)
            feat_slot[j] = slot_id
            feat_offset[j] = off
            off += mappers[j].num_bin - 1
        slot_bins.append(off + 1)
    slot_id = len(bundles)
    for j in range(f):
        if j not in bundled:
            feat_slot[j] = slot_id
            slot_bins.append(mappers[j].num_bin)
            slot_id += 1
    Log.info("Bundled %d sparse features into %d slots (%d stored rows "
             "for %d features)", len(bundled), len(bundles), slot_id, f)
    return BundlePlan(feat_slot, feat_offset, slot_bins, slot_id,
                      conflict_rate=max_conflict_rate)


def write_member(seg, col, off, dtype):
    """Write one member's (n,) bin column into its slot's row segment
    `seg` (a view); cells another member already holds keep that bin.
    Returns the number of such conflicts."""
    nz = col > 0
    taken = seg != 0
    write = nz & ~taken
    seg[write] = (col[write] + off).astype(dtype)
    return int((nz & taken).sum())


def log_conflicts(conflicts):
    if conflicts:
        Log.warning("Feature bundling: %d conflicting cells kept their "
                    "first member's bin", conflicts)


def build_stored_matrix(plan, bin_cols, dtype):
    """Full-data pass: write each feature's bin column into its slot.
    `bin_cols(j)` -> (N,) int bins of virtual feature j. Conflicting
    rows keep the first member's bin."""
    col0 = bin_cols(0)
    stored = np.zeros((plan.num_slots, len(col0)), dtype=dtype)
    conflicts = 0
    for j in range(len(plan.feat_slot)):
        col = col0 if j == 0 else bin_cols(j)
        conflicts += write_member(stored[plan.feat_slot[j]], col,
                                  plan.feat_offset[j], dtype)
    log_conflicts(conflicts)
    return stored


def expansion_maps(plan, num_bin_pf, b_virtual):
    """Static gather maps of the stored -> virtual histogram expansion.

    Returns src (F, b_virtual) int64 indices into the flattened
    (S * B_stored + 1,) stored histogram, whose last cell is a zero pad:
      hist_v[f, b] = hist_s_flat[src[f, b]]       for b >= 1
      hist_v[f, 0] = slot_total[feat_slot[f]] - sum_{b>=1} hist_v[f, b]
    """
    nb = np.asarray(num_bin_pf, np.int64)
    b_stored = int(plan.slot_bins.max())
    pad = plan.num_slots * b_stored
    bins = np.arange(b_virtual)[None, :]
    base = (plan.feat_slot.astype(np.int64) * b_stored
            + plan.feat_offset)[:, None]
    return np.where((bins >= 1) & (bins < nb[:, None]), base + bins, pad)
