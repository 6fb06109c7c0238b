"""lightgbm_tpu_torch's shard mesh and exchange layer on the CPU, against
the JAX package's (lightgbm_tpu/parallel/mesh.py, machines.py).

- mesh_fold_plain (ops/mesh_kernels.py), the plain version of the CUDA
  mesh_fold and what the CPU runs, equals JAX kahan_fold bit for bit for
  K = 2, 4 and 8 stacked components of mixed magnitudes (the
  compensation changes the result), with zeros of both signs, and on
  bfloat16 words;
- pair_allreduce, pair_reduce_scatter (groups 1 and 2),
  compressed_allreduce, compressed_reduce_scatter and compressed_psum on
  a 2- and a 4-shard LocalMesh equal the JAX functions under shard_map
  on the conftest's host devices: bit for bit at comm_precision pair and
  f32, and for bf16 the folds bit for bit while the bf16 psum (whose
  addition order XLA picks) is held to bf16's resolution;
- pair_reduce_scatter's owned block equals pair_allreduce on the same
  features bit for bit;
- CommPlan's formulas, MeshTopology's ownership and the ownership rules
  of machines.py equal the JAX ones (tests/test_comm.py:194, :248);
- the mesh's collectives (shard order, tiling, byte counts) and its
  failure modes: a shard that raises ends `run` with that error at once,
  and shards that reach different collectives fail, never hang.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.parallel import machines as jmachines
from lightgbm_tpu.parallel import mesh as jmesh
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.ops import mesh_kernels as mk
from lightgbm_tpu_torch.parallel import machines as tmachines
from lightgbm_tpu_torch.parallel import mesh as tmesh


@pytest.fixture(autouse=True)
def _one_thread():
    # many small CPU ops: one thread each keeps the suite's parallel
    # workers from oversubscribing
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    return a.view(np.int32)


def _components(k, shape, seed):
    """K components whose fixed-order compensated sum differs from the
    plain sum: large values that cancel, small ones that survive only
    through the compensation, and zeros of both signs."""
    rng = np.random.RandomState(seed)
    big = (rng.randn(k, *shape) * 1e6).astype(np.float32)
    big[k // 2:] = -big[:k - k // 2][::-1]
    small = (rng.randn(k, *shape) * 1e-3).astype(np.float32)
    x = big + small
    x[:, 0] = -0.0
    x[0, 1] = -0.0
    x[1:, 1] = 0.0
    x[:, 2] = np.float32(1e-30) * rng.randn(k, *shape[1:]).astype(np.float32)
    return x


@pytest.mark.parametrize("k", [2, 4, 8])
def test_mesh_fold_plain_is_jax_kahan_fold(k):
    comps = _components(k, (5, 7, 3), seed=k)
    want = np.asarray(jax.jit(jmesh.kahan_fold)(jnp.asarray(comps)))
    got = mk.mesh_fold_plain(torch.from_numpy(comps))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if k >= 4:
        # the compensation matters on these inputs (two words cancel
        # exactly or not at all)
        plain = np.zeros(comps.shape[1:], np.float32)
        for c in comps:
            plain = plain + c
        assert not np.array_equal(_bits(plain), _bits(want))
    # the CPU dispatch is the plain version
    np.testing.assert_array_equal(_bits(mk.mesh_fold(torch.from_numpy(comps))),
                                  _bits(want))


def test_mesh_fold_plain_bf16_words_are_jax_fold():
    comps = _components(8, (4, 9, 3), seed=11)
    wire = jnp.asarray(comps).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(
        lambda g: jmesh.kahan_fold(g.astype(jnp.float32)))(wire))
    got = mk.mesh_fold_plain(torch.from_numpy(comps).to(torch.bfloat16))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_mesh_fold_rejects_bad_input():
    with pytest.raises(ValueError):
        mk.mesh_fold(torch.zeros((0, 3)))
    with pytest.raises(TypeError):
        mk.mesh_fold(torch.zeros((2, 3), dtype=torch.float64))
    with pytest.raises(ValueError):
        mk.mesh_fold(torch.zeros((2, 3), device="meta"))


# ------------------------------------------------------------- exchanges

def _jax_shards(fn, inputs, w):
    """fn on each of w shards under shard_map (one host device each);
    inputs are (w, ...) stacks, one slice a shard. Returns the (w, ...)
    outputs."""
    mesh = Mesh(np.asarray(jax.devices()[:w]), (jmesh.AXIS,))

    def body(*xs):
        return fn(*[x[0] for x in xs])[None]

    f = jmesh.shard_map(body, mesh, in_specs=tuple(P(jmesh.AXIS)
                                                   for _ in inputs),
                        out_specs=P(jmesh.AXIS))
    return np.asarray(jax.jit(f)(*[jnp.asarray(x) for x in inputs]))


def _port_shards(fn, inputs, w):
    mesh = tmesh.LocalMesh(w, "cpu")
    outs = mesh.run(lambda r: fn(mesh, *[torch.from_numpy(x[r])
                                         for x in inputs]))
    return np.stack([o.numpy() for o in outs]), mesh


def _pairs(w, lead, f, seed):
    rng = np.random.RandomState(seed)
    hi = (rng.randn(w, *lead, f, 6, 3) * 1e4).astype(np.float32)
    lo = (rng.randn(w, *lead, f, 6, 3) * 1e-4).astype(np.float32)
    hi[:, ..., 0, 0, :] = -0.0
    return hi, lo


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("lead", [(), (1,)], ids=["leaf", "frontier"])
def test_pair_allreduce_is_jax(w, lead):
    hi, lo = _pairs(w, lead, 8, seed=w)
    want = _jax_shards(lambda a, b: jmesh.pair_allreduce((a, b)), [hi, lo], w)
    got, mesh = _port_shards(lambda m, a, b: tmesh.pair_allreduce((a, b), m),
                             [hi, lo], w)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # every shard the same bits; the bytes the wire model gives
    assert all(np.array_equal(_bits(got[0]), _bits(g)) for g in got)
    assert mesh.collective_bytes["hist_reduce"] == \
        tmesh.allgather_recv_bytes(2 * hi[0].nbytes, w)


@pytest.mark.parametrize("w,groups", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_pair_reduce_scatter_is_jax_and_the_allreduce_block(w, groups):
    f = 8
    hi, lo = _pairs(w, (), f, seed=10 + w + groups)
    want = _jax_shards(lambda a, b: jmesh.pair_reduce_scatter(
        (a, b), w, groups=groups), [hi, lo], w)
    got, mesh = _port_shards(lambda m, a, b: tmesh.pair_reduce_scatter(
        (a, b), m, w, groups=groups), [hi, lo], w)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    full, _ = _port_shards(lambda m, a, b: tmesh.pair_allreduce((a, b), m),
                           [hi, lo], w)
    f_loc = f // w
    for r in range(w):
        np.testing.assert_array_equal(
            _bits(got[r]), _bits(full[r][r * f_loc:(r + 1) * f_loc]))
    assert mesh.collective_bytes["hist_reduce"] == \
        2 * tmesh.alltoall_recv_bytes(hi[0].nbytes, w)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("w", [2, 4])
def test_compressed_exchanges_are_jax(w, precision):
    f = 8
    hi, lo = _pairs(w, (), f, seed=20 + w)
    want = _jax_shards(lambda a, b: jmesh.compressed_allreduce(
        (a, b), precision=precision), [hi, lo], w)
    got, _ = _port_shards(lambda m, a, b: tmesh.compressed_allreduce(
        (a, b), m, precision=precision), [hi, lo], w)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    want = _jax_shards(lambda a, b: jmesh.compressed_reduce_scatter(
        (a, b), w, groups=2, precision=precision), [hi, lo], w)
    got, mesh = _port_shards(lambda m, a, b: tmesh.compressed_reduce_scatter(
        (a, b), m, w, groups=2, precision=precision), [hi, lo], w)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    word = hi[0].nbytes // (2 if precision == "bf16" else 1)
    assert mesh.collective_bytes["hist_reduce"] == \
        tmesh.alltoall_recv_bytes(word, w)


@pytest.mark.parametrize("precision", ["pair", "f32", "bf16"])
def test_compressed_psum_is_jax(precision):
    w = 4
    x = (np.random.RandomState(5).randn(w, 3, 6, 3) * 10).astype(np.float32)
    want = _jax_shards(lambda a: jmesh.compressed_psum(
        a, precision=precision), [x], w)
    got, mesh = _port_shards(lambda m, a: tmesh.compressed_psum(
        a, m, precision=precision), [x], w)
    if precision == "bf16":
        # bf16 words added in an order XLA picks: the two sums part by at
        # most the rounding of W - 1 bf16 additions (2^-8 relative each)
        bound = w * 2.0 ** -8 * np.abs(x).sum(0)
        assert np.all(np.abs(got - want) <= bound[None])
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert all(np.array_equal(_bits(got[0]), _bits(g)) for g in got)
    word = x[0].nbytes // (2 if precision == "bf16" else 1)
    assert mesh.collective_bytes["hist_reduce"] == \
        tmesh.psum_recv_bytes(word, w)


def test_collectives_order_and_tiling():
    w = 4
    mesh = tmesh.LocalMesh(w, "cpu")

    def body(r):
        x = torch.arange(8, dtype=torch.float32) + 100 * r
        return (mesh.all_gather(x, "split_gather"),
                mesh.all_to_all(x.reshape(2, 4), 1),
                mesh.psum(torch.tensor([0.1 * (r + 1)]), "leaf_sync"))

    outs = mesh.run(body)
    for r, (g, a2a, s) in enumerate(outs):
        assert torch.equal(g, torch.stack([torch.arange(8.0) + 100 * j
                                           for j in range(w)]))
        # piece r of every shard, in source order
        want = torch.cat([(torch.arange(8.0) + 100 * j).reshape(2, 4)
                          [:, r:r + 1] for j in range(w)], dim=1)
        assert torch.equal(a2a, want)
        acc = torch.tensor([0.1])
        for j in range(1, w):
            acc = acc + torch.tensor([0.1 * (j + 1)])
        assert torch.equal(s, acc)             # shard index order
    assert mesh.collective_bytes == {
        "hist_reduce": 0,
        "split_gather": tmesh.allgather_recv_bytes(32, w),
        "leaf_sync": tmesh.psum_recv_bytes(4, w)}
    with pytest.raises(RuntimeError):
        mesh.psum(torch.ones(1))               # outside run


def test_a_failing_shard_ends_the_run_at_once():
    mesh = tmesh.LocalMesh(4, "cpu")

    def body(r):
        mesh.psum(torch.ones(2))
        if r == 2:
            raise ValueError("shard 2 failed")
        for _ in range(3):
            mesh.all_gather(torch.ones(2))
        return r

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="shard 2 failed"):
        mesh.run(body)
    assert time.perf_counter() - t0 < 5.0
    # the mesh runs again afterwards
    assert mesh.run(lambda r: float(mesh.psum(torch.tensor(1.0)))) == [4.0] * 4


def test_shards_out_of_lockstep_fail():
    mesh = tmesh.LocalMesh(3, "cpu")

    def body(r):
        if r == 1:
            return mesh.all_gather(torch.ones(1))
        return mesh.psum(torch.ones(1))

    with pytest.raises(tmesh.MeshLockstepError):
        mesh.run(body)

    def early(r):
        if r == 0:
            return None                        # leaves before its peers
        return mesh.psum(torch.ones(1))

    with pytest.raises(tmesh.MeshAborted):
        mesh.run(early)


# ------------------------------------------------- plans and ownership

def test_collective_bytes_formulas_are_jax():
    for nbytes, w in ((100, 4), (4, 3), (12, 2), (1000, 8)):
        for name in ("allgather_recv_bytes", "alltoall_recv_bytes",
                     "psum_recv_bytes"):
            assert getattr(tmesh, name)(nbytes, w) == \
                getattr(jmesh, name)(nbytes, w)
    assert tmesh.COLLECTIVE_KINDS == jmesh.COLLECTIVE_KINDS
    tp, jp = tmesh.CommPlan(), jmesh.CommPlan()
    for plan in (tp, jp):
        plan.add("hist_reduce", root=10, per_split=7)
        plan.add("split_gather", per_split=2)
    assert tp.per_tree(3) == jp.per_tree(3) == {
        "hist_reduce": 31, "split_gather": 6, "leaf_sync": 0}
    counts = {}
    assert tp.account(counts, 3) == 37
    assert counts == {"collective_bytes_hist_reduce": 31,
                      "collective_bytes_split_gather": 6,
                      "collective_bytes": 37}
    with pytest.raises(ValueError):
        tp.add("bogus", root=1)


def test_mesh_topology_is_jax():
    for machines in (2, 4):
        params = {"objective": "binary", "tree_learner": "data",
                  "num_machines": machines, "verbose": -1}
        tcfg, jcfg = TConfig.from_params(params), JConfig.from_params(params)
        tt = tmesh.MeshTopology(tmesh.LocalMesh(machines, "cpu"), tcfg)
        jt = jmesh.MeshTopology(jmesh.make_mesh(jcfg), jcfg)
        assert tt.n_shards == jt.n_shards == machines
        for f_pad in (8, 32):
            assert tt.feature_shard(f_pad) == jt.feature_shard(f_pad)
            assert tt.describe(f_pad) == jt.describe(f_pad)
            for shard in range(machines):
                assert tt.owned_block(shard, f_pad) == \
                    jt.owned_block(shard, f_pad)
                assert tt.owned_block_range(shard, 7) == \
                    jt.owned_block_range(shard, 7)
        for f_loc in (1, 7, 8, 16):
            assert tt.exchange_groups(f_loc) == jt.exchange_groups(f_loc)
    bad = TConfig.from_params({"verbose": -1})
    bad.comm_precision = "f16"
    with pytest.raises(Exception):
        tmesh.resolve_comm_precision(bad)


def test_ownership_rules_are_jax():
    for n in (1, 7, 30, 32):
        for k in (1, 2, 3, 4):
            for s in range(k):
                assert tmachines.partition_features(n, k, s) == \
                    jmachines.partition_features(n, k, s)
                assert tmachines.partition_blocks(n, k, s) == \
                    jmachines.partition_blocks(n, k, s)
            ranges = [tmachines.partition_blocks(n, k, s) for s in range(k)]
            tmachines.check_block_tiling(ranges, n)
    for ranges, n in (([(0, 2), (3, 5)], 5), ([(0, 2), (2, 4)], 5)):
        for mod in (tmachines, jmachines):
            with pytest.raises(ValueError):
                mod.check_block_tiling(ranges, n)


def test_shard_rows_match_the_jax_row_blocks():
    """shard_rows cuts the rows as the JAX learner's P(AXIS) sharding
    does below one scan chunk: W blocks of ceil(n / W)."""
    assert tmesh.shard_rows(10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert tmesh.shard_rows(5, 4) == [(0, 2), (2, 4), (4, 5), (5, 5)]
    assert tmesh.shard_rows(2000, 2) == [(0, 1000), (1000, 2000)]


def test_many_shards_in_lockstep_lose_no_update(monkeypatch):
    """More shard threads than cores, a short switch interval: every
    shard sees every contribution of every round, and the launch counter
    the shards share (hist_kernels._count, under its lock) loses no
    increment."""
    import sys
    import threading

    from lightgbm_tpu_torch.ops import hist_kernels as hk
    # _count asks whether a graph is being captured (no card here)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    w, rounds = 12, 40
    mesh = tmesh.LocalMesh(w, "cpu")
    stats = hk.KERNELS["mesh_fold"]
    before = stats.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def body(r):
            total = 0.0
            for i in range(rounds):
                g = mesh.all_gather(torch.tensor([float(r + i)]))
                total += float(g.sum())
            return total

        def count():
            for _ in range(2000):
                hk._count("mesh_fold")

        t0 = time.perf_counter()
        out = mesh.run(body)
        # the shards take turns; other threads may count at any time
        counters = [threading.Thread(target=count) for _ in range(w)]
        for t in counters:
            t.start()
        for t in counters:
            t.join(timeout=60)
            assert not t.is_alive()
        assert time.perf_counter() - t0 < 60.0
    finally:
        sys.setswitchinterval(interval)
    want = sum(sum(j + i for j in range(w)) for i in range(rounds))
    assert out == [float(want)] * w
    assert stats.launches - before == w * 2000
    stats.launches = before
    assert not [t for t in threading.enumerate()
                if t.name.startswith("mesh-shard-")]


@pytest.mark.parametrize("params", [
    {"comm_precision": "bf16", "hist_exchange": "allgather",
     "comm_groups": 3, "topk": 5},
    {"comm_precision": "F32", "hist_exchange": "reduce_scatter",
     "top_k": "7", "comm_groups": "1"},
    {"comm_precision": "f16"}, {"hist_exchange": "ring"},
    {"comm_groups": 0}],
    ids=["aliases", "strings", "bad_precision", "bad_exchange",
         "bad_groups"])
def test_comm_settings_parse_as_jax(params):
    """comm_precision, hist_exchange, comm_groups and top_k (alias topk)
    parse and are checked as in the JAX Config."""
    full = dict(params, objective="binary", tree_learner="data",
                num_machines=2, verbose=-1)
    try:
        j = JConfig.from_params(full)
    except Exception as e:                      # the JAX Config refuses
        with pytest.raises(Exception) as got:
            TConfig.from_params(full)
        assert type(got.value).__name__ == type(e).__name__
        assert str(got.value) == str(e)
        return
    t = TConfig.from_params(full)
    for key in ("comm_precision", "hist_exchange", "comm_groups", "top_k"):
        assert getattr(t, key) == getattr(j, key), key
    assert tmesh.resolve_comm_precision(t) == jmesh.resolve_comm_precision(j)
    assert tmesh.resolve_hist_exchange(t) == jmesh.resolve_hist_exchange(j)
