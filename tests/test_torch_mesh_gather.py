"""The gather-fold of lightgbm_tpu_torch's exchanges on the CPU, against
the JAX package (lightgbm_tpu/parallel/mesh.py).

Every histogram exchange of the port is one LocalMesh.fold_exchange: the
fold reads its components where they lie, through descriptors (tensor,
offset, stride) into the peers' own word tensors
(ops/mesh_kernels.py gather_fold; its plain version is what the CPU
runs). Held here:

- gather_fold_plain on strided descriptors (a leading frontier axis,
  each shard's owned feature block out of full histograms, W 2 and 4,
  float32 and bfloat16 words) equals mesh_fold_plain on the stacked
  components and the JAX kahan_fold on the same numpy stack, bit for
  bit, and writes a strided destination;
- pair_reduce_scatter and compressed_reduce_scatter at comm_groups 1, 2
  and 7, and the allgather exchanges, on a 2- and 4-shard LocalMesh
  equal the JAX functions under shard_map on the conftest's host
  devices bit for bit, and the bytes each counts are the JAX
  exchange's collectives' under the wire models (one all_gather, or one
  all_to_all a feature group);
- a shard that fails mid-exchange ends the run at once, and no fold
  starts once a shard has failed; descriptors that reach outside their
  tensor, mixed types and groups that do not tile the owned block
  raise.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.parallel import mesh as jmesh
from lightgbm_tpu_torch.ops import mesh_kernels as mk
from lightgbm_tpu_torch.parallel import mesh as tmesh
from test_torch_mesh import _bits, _jax_shards, _port_shards

F, B = 56, 6


@pytest.fixture(autouse=True)
def _one_thread():
    # many small CPU ops: one thread each keeps the suite's parallel
    # workers from oversubscribing
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shard_words(w, lead, seed, dtype=torch.float32):
    """(hi, lo) of W shards, each (W, *lead, F, B, 3): mixed magnitudes
    that the compensation moves, zeros of both signs."""
    rng = np.random.RandomState(seed)
    hi = (rng.randn(w, *lead, F, B, 3) * 1e6).astype(np.float32)
    hi[w // 2:] = -hi[:w - w // 2][::-1]
    hi += (rng.randn(w, *lead, F, B, 3) * 1e-3).astype(np.float32)
    flat = hi.reshape(w, -1)
    flat[:, 0] = -0.0
    flat[0, 1] = -0.0
    flat[1:, 1] = 0.0
    lo = (rng.randn(w, *lead, F, B, 3) * 1e-3).astype(np.float32)
    lo.reshape(w, -1)[:, 3] = -0.0
    return (torch.from_numpy(hi).to(dtype), torch.from_numpy(lo).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("lead", [(), (3,)], ids=["leaf", "frontier"])
@pytest.mark.parametrize("w", [2, 4])
def test_plain_gather_on_owned_blocks_is_the_stacked_fold(w, lead, dtype):
    hi, lo = _shard_words(w, lead, seed=w + len(lead), dtype=dtype)
    f_loc = F // w
    n_lead = int(np.prod(lead, dtype=np.int64))
    run, row = f_loc * B * 3, F * B * 3
    for r in range(w):
        words = [hi[j].contiguous() for j in range(w)] + \
            [lo[j].contiguous() for j in range(w)]
        comps = [(t, r * run, row) for t in words]
        got = mk.gather_fold_plain(comps, n_lead, run, torch.empty(
            (*lead, f_loc, B, 3)))
        stacked = torch.stack([t.narrow(-3, r * f_loc, f_loc)
                               for t in words])
        np.testing.assert_array_equal(_bits(got),
                                      _bits(mk.mesh_fold_plain(stacked)))
        jstack = jnp.asarray(stacked.float().numpy())
        want = np.asarray(jax.jit(jmesh.kahan_fold)(jstack))
        np.testing.assert_array_equal(_bits(got), _bits(want))
        # the CPU dispatch is the plain version
        again = mk.gather_fold(comps, n_lead, run, torch.empty_like(got))
        np.testing.assert_array_equal(_bits(again), _bits(got))


def test_plain_gather_writes_a_strided_destination():
    w, lead = 2, (3,)
    hi, lo = _shard_words(w, lead, seed=3)
    run, row = F * B * 3, F * B * 3
    comps = [(t[j].contiguous(), 0, row) for t in (hi, lo)
             for j in range(w)]
    # rows of the output 2 * run apart, the gaps left alone
    out = torch.full((3, 2 * run), 7.0)
    mk.gather_fold_plain(comps, 3, run, out, out_stride=2 * run)
    want = mk.mesh_fold_plain(torch.cat([hi, lo])).reshape(3, run)
    np.testing.assert_array_equal(_bits(out[:, :run]), _bits(want))
    assert torch.all(out[:, run:] == 7.0)


def test_gather_rejects_bad_descriptors():
    t = torch.zeros(10)
    out = torch.empty(4)
    with pytest.raises(ValueError, match="outside"):
        mk.gather_fold([(t, 7, 0)], 1, 4, out)
    with pytest.raises(ValueError, match="outside"):
        mk.gather_fold([(t, 0, 4)], 3, 4, torch.empty(12))
    with pytest.raises(ValueError, match="types"):
        mk.gather_fold([(t, 0, 0), (t.to(torch.bfloat16), 0, 0)], 1, 4, out)
    with pytest.raises(TypeError):
        mk.gather_fold([(t.double(), 0, 0)], 1, 4, out)
    with pytest.raises(ValueError):
        mk.gather_fold([(t, 0, 0)], 1, 4, torch.empty(3))
    with pytest.raises(ValueError):
        mk.gather_fold([(t.reshape(2, 5).t(), 0, 0)], 1, 4, out)
    with pytest.raises(ValueError):
        mk.gather_fold([(torch.zeros(10, device="meta"), 0, 0)], 1, 4, out)


# ------------------------------------------------------------- exchanges

def _pairs(w, lead, seed):
    hi, lo = _shard_words(w, lead, seed)
    return hi.numpy(), lo.numpy()


def _rs_bytes(lead, w, groups, words, word_bytes):
    """The JAX reduce-scatter's collectives: one all_to_all of `words`
    stacked words a feature group, each group's block (..., W * fg, B,
    3)."""
    fg = F // w // groups
    block = words * int(np.prod(lead, dtype=np.int64)) * w * fg * B * 3 \
        * word_bytes
    return groups * jmesh.alltoall_recv_bytes(block, w)


@pytest.mark.parametrize("groups", [1, 2, 7])
@pytest.mark.parametrize("w", [2, 4])
def test_pair_reduce_scatter_groups_are_jax(w, groups):
    lead = (1,) if groups == 2 else ()
    hi, lo = _pairs(w, lead, seed=30 + w + groups)
    want = _jax_shards(lambda a, b: jmesh.pair_reduce_scatter(
        (a, b), w, groups=groups), [hi, lo], w)
    got, mesh = _port_shards(lambda m, a, b: tmesh.pair_reduce_scatter(
        (a, b), m, w, groups=groups), [hi, lo], w)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert mesh.collective_bytes == {
        "hist_reduce": _rs_bytes(lead, w, groups, 2, 4),
        "split_gather": 0, "leaf_sync": 0}


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("groups", [1, 2, 7])
@pytest.mark.parametrize("w", [2, 4])
def test_compressed_reduce_scatter_groups_are_jax(w, groups, precision):
    hi, lo = _pairs(w, (), seed=40 + w + groups)
    want = _jax_shards(lambda a, b: jmesh.compressed_reduce_scatter(
        (a, b), w, groups=groups, precision=precision), [hi, lo], w)
    got, mesh = _port_shards(lambda m, a, b: tmesh.compressed_reduce_scatter(
        (a, b), m, w, groups=groups, precision=precision), [hi, lo], w)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert mesh.collective_bytes["hist_reduce"] == _rs_bytes(
        (), w, groups, 1, 2 if precision == "bf16" else 4)


@pytest.mark.parametrize("precision", ["pair", "f32", "bf16"])
@pytest.mark.parametrize("w", [2, 4])
def test_allgather_exchanges_are_jax(w, precision):
    hi, lo = _pairs(w, (2,), seed=50 + w)
    if precision == "pair":
        jfn = lambda a, b: jmesh.pair_allreduce((a, b))          # noqa: E731
        tfn = lambda m, a, b: tmesh.pair_allreduce((a, b), m)    # noqa: E731
        nbytes = 2 * hi[0].nbytes
    else:
        jfn = lambda a, b: jmesh.compressed_allreduce(           # noqa: E731
            (a, b), precision=precision)
        tfn = lambda m, a, b: tmesh.compressed_allreduce(        # noqa: E731
            (a, b), m, precision=precision)
        nbytes = hi[0].nbytes // (2 if precision == "bf16" else 1)
    want = _jax_shards(jfn, [hi, lo], w)
    got, mesh = _port_shards(tfn, [hi, lo], w)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert mesh.collective_bytes["hist_reduce"] == \
        jmesh.allgather_recv_bytes(nbytes, w)


def test_reduce_scatter_refuses_groups_that_do_not_tile():
    hi, lo = _pairs(2, (), seed=1)
    mesh = tmesh.LocalMesh(2, "cpu")
    with pytest.raises(ValueError, match="tile"):
        mesh.run(lambda r: tmesh.pair_reduce_scatter(
            (torch.from_numpy(hi[r]), torch.from_numpy(lo[r])), mesh, 2,
            groups=5))


# ------------------------------------------------------------- failures

def test_a_shard_failing_mid_exchange_ends_the_run_at_once():
    w = 4
    hi, lo = _pairs(w, (), seed=60)
    mesh = tmesh.LocalMesh(w, "cpu")

    def body(r):
        pair = (torch.from_numpy(hi[r]), torch.from_numpy(lo[r]))
        tmesh.pair_reduce_scatter(pair, mesh, w)
        if r == 2:
            raise ValueError("shard 2 failed")
        for _ in range(3):
            tmesh.pair_allreduce(pair, mesh)
        return r

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="shard 2 failed"):
        mesh.run(body)
    assert time.perf_counter() - t0 < 5.0
    # the mesh exchanges again afterwards
    got = mesh.run(lambda r: tmesh.pair_allreduce(
        (torch.from_numpy(hi[r]), torch.from_numpy(lo[r])), mesh))
    assert all(torch.equal(g, got[0]) for g in got)


def test_no_fold_starts_after_a_shard_failed(monkeypatch):
    """A shard whose fold raises aborts the mesh: a shard that reads
    after it raises MeshAborted and enqueues no fold."""
    w = 4
    hi, lo = _pairs(w, (), seed=61)
    mesh = tmesh.LocalMesh(w, "cpu")
    calls = []
    fold = tmesh.gather_fold

    def failing(*args, **kwargs):
        calls.append(mesh.rank())
        if mesh.rank() == 1:
            raise RuntimeError("fold on shard 1 failed")
        return fold(*args, **kwargs)

    monkeypatch.setattr(tmesh, "gather_fold", failing)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        mesh.run(lambda r: tmesh.pair_allreduce(
            (torch.from_numpy(hi[r]), torch.from_numpy(lo[r])), mesh))
    assert time.perf_counter() - t0 < 5.0
    assert calls[-1] == 1 and calls.count(1) == 1
