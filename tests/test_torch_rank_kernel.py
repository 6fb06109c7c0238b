"""The LambdaRank pair-gradient kernel's plain version, on the CPU.

ops/rank_kernels.py holds csrc/rank.cu's wrapper and its plain PyTorch
version. The kernel runs only on a card (tests/test_torch_rank_card.py
holds it to the plain version there); these tests pin what it computes:
- its ranks by counting (rank_i = #{j : s_j > s_i} + #{j < i : s_j ==
  s_i}, NaN after every number) are the inverse of argsort(-s,
  stable=True) on ties, +-0.0, -inf and NaN scores and one-row queries;
- the plain version, which sums each row's and each column's pair terms
  in column order from +0.0, gives the same bits in blocks of any size;
- it stays within 1e-5 of the largest |value| of the JAX package's
  make_lambdarank_gradfn (both float32; the sums' order differs), with
  weights, ties and a query of equal labels;
- a torch transcription of the kernel's walk (a query unpadded, a
  thread a row in lockstep, j in row order, the high row's values
  first, each operation in the kernel's order) equals the plain version
  bit for bit, edge scores included (NaN compared by position);
- where the two packages part on NaN scores: the JAX package ranks a
  query's padded slots (score -inf) between its numbers and its NaNs,
  so a finite row's gradient there depends on the padded width; the
  port's equals the JAX package's on the unpadded query.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.objectives.rank_device import (
    PaddedQueryLayout as JLayout, make_lambdarank_gradfn as jgradfn)
from lightgbm_tpu_torch.metrics.dcg_calculator import DCGCalculator
from lightgbm_tpu_torch.ops import rank_kernels as rk

LABEL_GAIN = JConfig.from_params({"objective": "lambdarank"}).label_gain
SIG = 1.0


def _queries(seed, nq=40, max_docs=30):
    """Query lengths 1..max_docs (one-row queries first and fifth), labels
    0-4, the third query's labels all equal."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(2, max_docs + 1, nq)
    counts[0] = counts[4] = 1
    n = int(counts.sum())
    label = rng.randint(0, 5, n).astype(np.float32)
    qb = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    label[qb[2]:qb[3]] = 2.0
    return label, qb


def _edge_scores(n, seed):
    """Ties, +-0.0, -inf and NaN among random scores."""
    rng = np.random.RandomState(seed)
    s = rng.randn(n).astype(np.float32)
    s[::3] = np.round(s[::3])
    s[rng.rand(n) < 0.1] = 0.0
    s[rng.rand(n) < 0.1] = -0.0
    s[rng.rand(n) < 0.05] = -np.inf
    s[rng.rand(n) < 0.03] = np.nan
    return s


def _inputs(label, qb, weights=None):
    """The wrapper's inputs of (label, qb), as make_lambdarank_gradfn
    builds them."""
    dcg = DCGCalculator(LABEL_GAIN)
    lab = label.astype(np.int64)
    inv = np.zeros(len(qb) - 1)
    for q in range(len(qb) - 1):
        m = dcg.cal_maxdcg_at_k(20, lab[qb[q]:qb[q + 1]])
        inv[q] = 1.0 / m if m > 0 else 0.0
    f32 = torch.float32
    return dict(
        qb=torch.from_numpy(qb.astype(np.int32)),
        gain=torch.from_numpy(dcg.label_gain[lab]).to(f32),
        inv=torch.from_numpy(inv).to(f32),
        weight=None if weights is None else torch.from_numpy(weights),
        disc=torch.from_numpy(dcg.discount).to(f32),
        sigmoid=SIG, max_docs=int(np.diff(qb).max()))


def _plain(score, args, block_queries=None):
    return rk.lambdarank_grad_plain(torch.from_numpy(score[None, :]),
                                    block_queries=block_queries, **args)


def _counting_ranks(s):
    """csrc/rank.cu's ranks: j is ahead of i when s_j > s_i, or s_j ==
    s_i with j < i; a NaN s_i has every number and the NaNs before it
    ahead of it."""
    n = len(s)
    j = torch.arange(n)[None, :]
    i = torch.arange(n)[:, None]
    si, sj = s[:, None], s[None, :]
    nan_i = torch.isnan(si)
    ahead = torch.where(nan_i, ~torch.isnan(sj) | (j < i),
                        (sj > si) | ((sj == si) & (j < i)))
    return ahead.sum(1)


def _bits_equal(a, b):
    """Equal bits where neither is NaN, NaN at the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0).view(torch.int32),
        b.masked_fill(nb, 0).view(torch.int32)))


@pytest.mark.parametrize("seed", range(6))
def test_ranks_by_counting_equal_stable_argsort(seed):
    rng = np.random.RandomState(seed)
    for n in (1, 2, 3, 17, 64):
        s = torch.from_numpy(_edge_scores(n, seed * 100 + n))
        if seed == 5:
            s[:] = float(rng.choice([0.0, -0.0, -np.inf, np.nan]))
        order = torch.argsort(-s, stable=True)
        inverse = torch.empty_like(order).scatter_(0, order,
                                                   torch.arange(n))
        assert torch.equal(_counting_ranks(s), inverse), s


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
def test_plain_bits_do_not_depend_on_blocks(weighted):
    label, qb = _queries(1)
    n = len(label)
    w = (np.random.RandomState(2).rand(n).astype(np.float32) + 0.5
         if weighted else None)
    args = _inputs(label, qb, w)
    score = _edge_scores(n, 3)
    score[np.isnan(score)] = 1.5
    whole = _plain(score, args, block_queries=len(qb))
    for block in (1, 3, 7):
        got = _plain(score, args, block_queries=block)
        for a, b in zip(got, whole):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert not torch.signbit(whole[0][whole[0] == 0]).any()


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_plain_matches_jax(weighted, ties):
    label, qb = _queries(4)
    n = len(label)
    w = (np.random.RandomState(5).rand(n).astype(np.float32) + 0.5
         if weighted else None)
    rng = np.random.RandomState(6)
    score = rng.randn(n).astype(np.float32)
    if ties:
        score[::3] = np.round(score[::3])
    jg, jh = jgradfn(JLayout(qb, n), label, LABEL_GAIN, SIG, 20, w)(
        jnp.asarray(score[None, :]))
    tg, th = _plain(score, _inputs(label, qb, w))
    for got, want in ((tg.numpy(), np.asarray(jg)),
                      (th.numpy(), np.asarray(jh))):
        assert got.shape == want.shape == (1, n)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # one-row queries and the equal-label query get no gradient
    assert tg[0, 0] == 0 and th[0, qb[4]] == 0
    assert not tg[0, qb[2]:qb[3]].any()


def _kernel_walk(score, qb, gain, inv, weight, disc, sigmoid):
    """csrc/rank.cu's lambdarank_pairs_kernel in torch: each query
    unpadded, its rows as the block's threads in lockstep, j in row
    order, each pair term in pair_term's operations and order."""
    lo, hi = rk.clamp_bounds(sigmoid)
    n = score.shape[0]
    grad = torch.zeros(n)
    hess = torch.zeros(n)
    k_max = disc.shape[0] - 1
    for q in range(qb.shape[0] - 1):
        r0, r1 = int(qb[q]), int(qb[q + 1])
        cnt = r1 - r0
        if cnt <= 0:
            continue
        s, g = score[r0:r1], gain[r0:r1]
        rank = _counting_ranks(s)
        d = disc[rank.clamp(max=k_max)]
        best = s[rank == 0][0]
        worst = s[rank == cnt - 1][0]
        if worst == -np.inf and cnt > 1:
            worst = s[rank == cnt - 2][0]
        norm = bool(best != worst)
        rg, cg, rh, ch = (torch.zeros(cnt) for _ in range(4))
        for j in range(cnt):
            row = (g - g[j]) > 0
            col = (g[j] - g) > 0
            sh, sl = torch.where(row, s, s[j]), torch.where(row, s[j], s)
            gh, gl = torch.where(row, g, g[j]), torch.where(row, g[j], g)
            dh, dl = torch.where(row, d, d[j]), torch.where(row, d[j], d)
            ds = sh - sl
            delta = ((gh - gl) * torch.abs(dh - dl)) * inv[q]
            if norm:
                delta = delta / (0.01 + torch.abs(ds))
            x = torch.where(ds < lo, lo, ds)
            x = torch.where(x > hi, hi, x)
            e = torch.exp((2.0 * x) * sigmoid)
            p = torch.reciprocal(1.0 + e) * 2.0
            ph = p * (2.0 - p)
            lam = (-p) * delta
            hes = (2.0 * ph) * delta
            rg = torch.where(row, rg + lam, rg)
            rh = torch.where(row, rh + hes, rh)
            cg = torch.where(col, cg + lam, cg)
            ch = torch.where(col, ch + hes, ch)
        gq, hq = rg - cg, rh + ch
        if weight is not None:
            gq, hq = gq * weight[r0:r1], hq * weight[r0:r1]
        grad[r0:r1] = gq + 0.0
        hess[r0:r1] = hq + 0.0
    return grad[None, :], hess[None, :]


@pytest.mark.parametrize("case", ["random", "edges", "weights", "outside"])
def test_kernel_walk_equals_plain(case):
    label, qb = _queries(7, nq=25)
    n = len(label)
    w = (np.random.RandomState(8).rand(n).astype(np.float32) + 0.5
         if case == "weights" else None)
    if case == "outside":           # rows before and after every query
        qb = qb[3:-2]
    args = _inputs(label, qb, w)
    score = (_edge_scores(n, 9) if case == "edges"
             else np.random.RandomState(9).randn(n).astype(np.float32))
    want = _plain(score, args)
    kw = {k: v for k, v in args.items() if k != "max_docs"}
    got = _kernel_walk(torch.from_numpy(score), **kw)
    for a, b in zip(got, want):
        assert _bits_equal(a, b)
    if case == "outside":
        assert not want[0][0, :qb[0]].any() and not want[0][0, qb[-1]:].any()
        assert want[0][0, qb[0]:qb[-1]].any()
    if case == "edges":
        assert torch.isnan(want[0]).any()      # a NaN score reaches its pairs


def test_wrapper_dispatches_by_device_and_checks():
    label, qb = _queries(10, nq=5)
    args = _inputs(label, qb)
    score = torch.randn(1, len(label))
    before = rk.KERNELS["lambdarank_pairs"].launches
    got = rk.lambdarank_pairs(score, **args)
    assert rk.KERNELS["lambdarank_pairs"].launches == before   # plain ran
    want = rk.lambdarank_grad_plain(score, **args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        rk.lambdarank_pairs(score[0], **args)                # not (1, N)
    with pytest.raises(ValueError):
        rk.lambdarank_pairs(score, **dict(args, qb=args["qb"].long()))
    with pytest.raises(ValueError):
        rk.lambdarank_pairs(score, **dict(args, gain=args["gain"][:-1]))
    with pytest.raises(ValueError):
        rk.lambdarank_pairs(score.to("meta"), **args)


def test_nan_scores_part_from_jax_only_through_its_padding():
    # query A: rows 0 and 1 score 0.0, row 2 NaN; rows 0 and 2 share a
    # label, so row 0 pairs only with row 1 (a finite pair). Query B pads
    # A to M = 6 in the JAX layout.
    rng = np.random.RandomState(12)
    label = np.array([2, 0, 2, *rng.randint(0, 5, 6)], np.float32)
    score = np.array([0.0, 0.0, np.nan, *rng.randn(6)], np.float32)
    qb = np.array([0, 3, 9], np.int64)
    n = len(label)
    tg, th = _plain(score, _inputs(label, qb))
    ag, ah = _plain(score[:3], _inputs(label[:3], qb[:2]))
    jg, jh = (np.asarray(v)[0] for v in jgradfn(
        JLayout(qb, n), label, LABEL_GAIN, SIG, 20, None)(
            jnp.asarray(score[None, :])))
    kg, kh = (np.asarray(v)[0] for v in jgradfn(
        JLayout(qb[:2], 3), label[:3], LABEL_GAIN, SIG, 20, None)(
            jnp.asarray(score[None, :3])))
    # the port: row 0 the same bits with and without the other query
    assert tg[0, 0] == ag[0, 0] != 0 and th[0, 0] == ah[0, 0] != 0
    assert torch.isnan(tg[0, 1:3]).all() and np.isnan(jg[1:3]).all()
    # the JAX package unpadded agrees with the port (1e-5, as above)
    for got, want in ((tg[0, 0], kg[0]), (th[0, 0], kh[0])):
        assert abs(float(got) - want) <= 1e-5 * abs(want)
    # padded, its kMinScore rule takes a -inf slot for the worst score,
    # finds best == worst (both 0.0) and drops the 1 / (0.01 + |ds|)
    # factor: row 0 is 100 times smaller
    for got, want in ((tg[0, 0], jg[0]), (th[0, 0], jh[0])):
        assert abs(float(got) - 100.0 * want) <= 1e-4 * abs(float(got))
    # query B holds no NaN: the two packages agree there
    for got, want in ((tg[0, 3:], jg[3:]), (th[0, 3:], jh[3:])):
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
