"""lightgbm_tpu_torch's parallel learners on the card.

- CUDA mesh_fold (csrc/mesh.cu) equals its plain version bit for bit, on
  the card and on the CPU, for float32 components (K = 2 and 8, the
  pair exchange's 2W words at 1 and 4 shards, on a frontier root's
  (1, F, B, 3) histogram and a reduce-scatter shard's (f_loc, B, 3)
  block) and bfloat16 words (comm_precision=bf16), with zeros of both
  signs; two launches agree and each counts one launch;
- the gather-fold (gather_fold, the same kernel on descriptors into
  separate tensors) equals its plain version bit for bit on strided
  views: K = 2W for W = 1, 2, 4, 8, 64 and 65 (past the launch's 128
  descriptors: two passes, two launches), each shard's owned block or
  the whole histogram, with and without a frontier axis, float32 and
  bfloat16, into a strided destination;
- the exchanges on a 4-shard mesh sharing the card (pair allgather, pair
  reduce-scatter at comm_groups 1, 2 and 7, the compressed ones) give
  the CPU mesh's bits, with one mesh_fold launch a shard an exchange,
  also when the shards enqueue on a stream of their own;
- the data-parallel learner (reduce-scatter and allgather, 2 and 4
  shards sharing the card) grows the serial masked learner's trees on
  the card (same split features and thresholds, leaf values within rtol
  1e-5 and atol 1e-6: a shard's 4096-row chunks are not the serial
  learner's, so each histogram cell parts in its last float32 bits, and
  the split scan's sums on the card run in an order that follows the
  histogram's shape; a leaf near zero, whose gradients cancel, keeps
  that absolute error), its folds go through mesh_fold, and its counted
  collective bytes equal its CommPlan;
- a shard that raises on the card ends training with its error;
- with more than one card, the shards of every learner spread over the
  cards and the trees stay the serial ones (skips on one card).
- a process gang of ranks (tests/test_torch_distributed.py's mesh
  worker, one process a rank) gives an in-process LocalMesh's bits for
  every collective and exchange, with one gather_fold an exchange into
  the collective's receive buffer: two ranks sharing the card over gloo
  with pinned host copies, and with more than one card min(cards, 4)
  ranks over NCCL (skips on one card).
- the out-of-core gang learner (data/ooc_parallel.py) on two CLI ranks
  sharing the card over gloo with pinned host copies, over one shared
  block store: both ranks hold one model, every pass launched
  hist_pair_fold for each owned block and mesh_fold once an exchange,
  its trees have the serial out-of-core learner's leaf counts and its
  training log loss is the serial learner's within 1e-3 relative. The
  gang's fold order parts from the serial carry's in the last bit of
  some histogram cells, so a near-tie split can part (on this fixture it
  does: predictions move by up to 1.4e-3); tests/test_torch_elastic_ooc.py
  holds the trees against the JAX package's gang learner on the CPU.

They need a CUDA device and skip without one (`cuda` marker). They
import neither JAX nor the JAX package:

    python -m pytest tests/test_torch_parallel_card.py -m cuda --noconftest
"""

import os

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import hist_kernels as hk
from lightgbm_tpu_torch.ops import mesh_kernels as mk
from lightgbm_tpu_torch.parallel import mesh

BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 10,
        "verbose": -1, "hist_compaction": "false"}

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _components(k, shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((k, *shape), generator=g) * 1e4
    x[k // 2:] -= x[:k - k // 2].flip(0)          # cancelling words
    x = x + torch.randn((k, *shape), generator=g) * 1e-3
    flat = x.reshape(k, -1)
    flat[:, 0] = -0.0
    flat[0, 1] = -0.0
    flat[1:, 1] = 0.0
    return x.to(dtype)


@pytest.mark.parametrize("k,shape,dtype", [
    (2, (28, 255, 3), torch.float32),
    (8, (1, 28, 255, 3), torch.float32),
    (8, (7, 255, 3), torch.float32),
    (4, (28, 255, 3), torch.bfloat16)],
    ids=["k2", "k8_frontier", "k8_owned_block", "bf16"])
def test_mesh_fold_is_its_plain_version(k, shape, dtype):
    _need_card()
    comps = _components(k, shape, seed=k, dtype=dtype)
    dev = comps.cuda()
    before = hk.KERNELS["mesh_fold"].launches
    a, b = mk.mesh_fold(dev), mk.mesh_fold(dev)
    assert hk.KERNELS["mesh_fold"].launches == before + 2
    assert a.dtype == torch.float32 and a.shape == shape
    want_card = mk.mesh_fold_plain(dev)
    want_cpu = mk.mesh_fold_plain(comps)
    for want in (want_card.cpu(), want_cpu):
        assert torch.equal(a.cpu().view(torch.int32),
                           want.view(torch.int32))
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_max_comps_is_the_kernels():
    _need_card()
    assert hk._library("mesh.cu").gather_fold_max_comps() == mk.MAX_COMPS


def _words(w, lead, f, b, seed, dtype):
    """(hi, lo) of W shards, each a list of W contiguous (*lead, f, b, 3)
    tensors: cancelling values, small residuals, zeros of both signs."""
    g = torch.Generator().manual_seed(seed)
    hi = torch.randn((w, *lead, f, b, 3), generator=g) * 1e4
    hi[w // 2:] -= hi[:w - w // 2].flip(0)
    hi = hi + torch.randn((w, *lead, f, b, 3), generator=g) * 1e-3
    hi.reshape(w, -1)[:, 0] = -0.0
    hi.reshape(w, -1)[1:, 1] = 0.0
    lo = torch.randn((w, *lead, f, b, 3), generator=g) * 1e-4
    return ([t.to(dtype).contiguous() for t in hi],
            [t.to(dtype).contiguous() for t in lo])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("lead", [(), (3,)], ids=["leaf", "frontier"])
@pytest.mark.parametrize("scatter", [False, True], ids=["full", "owned"])
@pytest.mark.parametrize("w", [1, 2, 4, 8, 64, 65])
def test_gather_fold_is_its_plain_version(w, scatter, lead, dtype):
    _need_card()
    f, b = 2 * w, 17
    hi, lo = _words(w, lead, f, b, seed=w, dtype=dtype)
    n_lead = 3 if lead else 1
    row = f * b * 3
    r = w - 1                                   # the last shard's block
    run, off = (2 * b * 3, r * 2 * b * 3) if scatter else (row, 0)
    host = [(t, off, row) for t in hi + lo]
    dev = [(t.cuda(), off, row) for t in hi + lo]
    out_stride = run + 5                        # a strided destination
    passes = -(-2 * w // mk.MAX_COMPS)
    before = hk.KERNELS["mesh_fold"].launches
    outs = [torch.full((n_lead * out_stride,), 3.0, device="cuda")
            for _ in range(2)]
    for out in outs:
        mk.gather_fold(dev, n_lead, run, out, out_stride)
    assert hk.KERNELS["mesh_fold"].launches == before + 2 * passes
    want_card = mk.gather_fold_plain(dev, n_lead, run, torch.full_like(
        outs[0], 3.0), out_stride)
    want_cpu = mk.gather_fold_plain(host, n_lead, run, torch.full(
        (n_lead * out_stride,), 3.0), out_stride)
    for want in (want_card.cpu(), want_cpu):
        assert torch.equal(outs[0].cpu().view(torch.int32),
                           want.view(torch.int32))
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))


EXCHANGES = {
    "pair_allgather": lambda m, p: mesh.pair_allreduce(p, m),
    "pair_rs_1": lambda m, p: mesh.pair_reduce_scatter(p, m, 4, groups=1),
    "pair_rs_2": lambda m, p: mesh.pair_reduce_scatter(p, m, 4, groups=2),
    "pair_rs_7": lambda m, p: mesh.pair_reduce_scatter(p, m, 4, groups=7),
    "f32_allgather": lambda m, p: mesh.compressed_allreduce(p, m, "f32"),
    "bf16_rs_7": lambda m, p: mesh.compressed_reduce_scatter(
        p, m, 4, groups=7, precision="bf16"),
}


@pytest.mark.parametrize("side_stream", [False, True],
                         ids=["default_stream", "side_stream"])
@pytest.mark.parametrize("name", list(EXCHANGES))
def test_exchanges_on_one_card_are_the_cpu_ones(name, side_stream):
    _need_card()
    w, fn = 4, EXCHANGES[name]
    hi, lo = _words(w, (1,), 56, 255, seed=7, dtype=torch.float32)
    cpu = mesh.LocalMesh(w, "cpu")
    want = cpu.run(lambda r: fn(cpu, (hi[r], lo[r])))
    card = mesh.LocalMesh(w, "cuda")
    dev = [(a.cuda(), b.cuda()) for a, b in zip(hi, lo)]
    streams = [torch.cuda.Stream() for _ in range(w)]

    def shard(r):
        if not side_stream:
            return fn(card, dev[r])
        with torch.cuda.stream(streams[r]):
            streams[r].wait_stream(torch.cuda.default_stream())
            out = fn(card, dev[r])
        torch.cuda.default_stream().wait_stream(streams[r])
        return out

    before = hk.KERNELS["mesh_fold"].launches
    got = card.run(shard)
    torch.cuda.synchronize()
    assert hk.KERNELS["mesh_fold"].launches == before + w
    for g, want_r in zip(got, want):
        assert torch.equal(g.cpu().view(torch.int32),
                           want_r.view(torch.int32))
    assert card.collective_bytes == cpu.collective_bytes


def _data(n=20000, f=10, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] - x[:, 2] * x[:, 3]
         + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return x, y


@pytest.mark.parametrize("w,exchange", [(2, "auto"), (4, "auto"),
                                        (4, "allgather")])
def test_data_parallel_tree_on_the_card_is_serial(w, exchange):
    _need_card()
    x, y = _data()
    ds = lgt.Dataset(x, y)
    ser = lgt.train(BASE, ds, 3)
    hk.reset_launch_counts()
    par = lgt.train(dict(BASE, tree_learner="data", num_machines=w,
                         hist_exchange=exchange), ds, 3)
    learner = par.gbdt.tree_learner
    assert learner.mesh.devices[0].type == "cuda"
    assert learner.use_reduce_scatter is (exchange == "auto")
    assert hk.KERNELS["mesh_fold"].launches >= 3 * 15
    assert hk.KERNELS["masked_hist"].launches >= 3 * 14 * w
    for ta, tb in zip(ser.gbdt.models, par.gbdt.models):
        np.testing.assert_array_equal(ta.split_feature, tb.split_feature)
        np.testing.assert_array_equal(ta.threshold_in_bin,
                                      tb.threshold_in_bin)
        np.testing.assert_allclose(ta.leaf_value, tb.leaf_value, rtol=1e-5,
                                   atol=1e-6)
    counted = learner.mesh.collective_bytes
    assert counted == {k: learner.collective_bytes.get(
        f"collective_bytes_{k}", 0) for k in counted}


def test_a_failing_shard_on_the_card_raises():
    _need_card()
    b = lgt.Booster(dict(BASE, tree_learner="data", num_machines=4),
                    lgt.Dataset(*_data(n=5000)))
    b.update()
    learner = b.gbdt.tree_learner
    inner = learner._shard_fn

    def failing(r, *args):
        if r == 1:
            raise RuntimeError("shard 1 failed")
        return inner(r, *args)

    learner._shard_fn = failing
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        b.update()
    torch.cuda.synchronize()


@pytest.mark.parametrize("learner,extra", [
    ("data", {}), ("data", {"hist_exchange": "allgather"}),
    ("data", {"partitioned_build": "true"}), ("feature", {}),
    ("voting", {"top_k": 10})],
    ids=["data_rs", "data_allgather", "data_partitioned", "feature",
         "voting"])
def test_shards_spread_over_the_cards(learner, extra):
    """With more than one card the shards live on cards r mod D: the
    exchanges copy between cards behind CUDA events, and the trees stay
    the serial learner's (voting with every feature voted)."""
    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs more than one CUDA device")
    x, y = _data()
    ds = lgt.Dataset(x, y)
    base = dict(BASE, **extra)
    ser = lgt.train(base, ds, 3)
    par = lgt.train(dict(base, tree_learner=learner, num_machines=4), ds, 3)
    mesh = par.gbdt.tree_learner.mesh
    assert mesh.multi_device
    assert len(set(mesh.devices)) == min(4, torch.cuda.device_count())
    rtol = 2e-4 if "partitioned_build" in extra else 1e-5
    for ta, tb in zip(ser.gbdt.models, par.gbdt.models):
        np.testing.assert_array_equal(ta.split_feature, tb.split_feature)
        np.testing.assert_array_equal(ta.threshold_in_bin,
                                      tb.threshold_in_bin)
        np.testing.assert_allclose(ta.leaf_value, tb.leaf_value, rtol=rtol,
                                   atol=1e-6)
    np.testing.assert_allclose(np.ravel(par.predict(x)),
                               np.ravel(ser.predict(x)), atol=1e-5)


@pytest.mark.parametrize("transport", ["gloo+pinned", "nccl"])
def test_process_gang_exchanges_are_the_local_mesh(transport):
    """A process gang on the card (tests/test_torch_distributed.py's mesh
    ranks, one process a rank): every ProcessMesh collective and exchange
    bit-equal to an in-process LocalMesh on the same inputs, one
    gather_fold an exchange into the receive buffer, the lockstep fault
    raised. Two ranks sharing one card over gloo with pinned host
    copies; with two cards or more, min(cards, 4) ranks over NCCL."""
    _need_card()
    import test_torch_distributed as td
    if transport == "nccl":
        if torch.cuda.device_count() < 2:
            pytest.skip("NCCL needs a card a rank: one card here")
        w = min(torch.cuda.device_count(), 4)
    else:
        w = 2
    # NCCL comes from the topology (a card a rank); the shared card is
    # forced (every rank on card 0)
    reports = td._mesh_reports(w, "cuda", "auto" if transport == "nccl"
                               else transport)
    assert {r["transport"] for r in reports} == {transport}
    td.check_mesh_reports(reports, w)


def test_out_of_core_gang_on_the_card(tmp_path):
    _need_card()
    import ast
    import subprocess
    import sys
    import test_torch_distributed as td
    rng = np.random.RandomState(5)
    n, f, rounds, leaves = 20000, 6, 3, 15
    x = rng.rand(n, f)
    y = ((x[:, 0] + x[:, 1] * x[:, 2]) > 0.9).astype(int)
    csv = tmp_path / "tr.csv"
    np.savetxt(csv, np.column_stack([y, x]), delimiter=",", fmt="%.6f")
    mlist = td._machine_list(tmp_path / "mlist.txt", 2)
    common = ["task=train", f"data={csv}", "objective=binary",
              f"num_leaves={leaves}", f"num_iterations={rounds}",
              "out_of_core=true", "block_rows=4096",
              "device_row_chunk=4096", "hist_compaction=false",
              "min_data_in_leaf=10", "metric_freq=0",
              "enable_load_from_binary_file=false", "verbose=1"]
    argv = common + ["tree_learner=data", "num_machines=2",
                     f"machine_list_file={mlist}",
                     f"output_model={tmp_path / 'gang.txt'}"]
    procs = []
    for r in range(2):
        env = dict(os.environ, LIGHTGBM_TPU_RANK=str(r),
                   CUDA_VISIBLE_DEVICES="0", PYTHONPATH=td.REPO)
        env.pop("LIGHTGBM_TPU_FAULTS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "lightgbm_tpu_torch"] + argv, env=env,
            cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append((p.returncode, out))
    launches = []
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r}:\n{out[-3000:]}"
        assert "transport=gloo+pinned" in out
        line = [ln for ln in out.splitlines()
                if "kernel launches in this process:" in ln][-1]
        launches.append(ast.literal_eval(line.split(
            "kernel launches in this process:", 1)[1].strip()))
    # rank 0 owns 3 blocks, rank 1 two; a pass a split and the root
    passes = rounds * leaves
    assert [c["hist_pair_fold"] for c in launches] == [3 * passes,
                                                       2 * passes]
    assert [c["mesh_fold"] for c in launches] == [passes, passes]
    params = {"objective": "binary", "num_leaves": leaves,
              "min_data_in_leaf": 10, "hist_compaction": "false",
              "device_row_chunk": 4096, "out_of_core": True,
              "block_rows": 4096, "verbose": -1,
              "enable_load_from_binary_file": False,
              "ooc_dir": str(tmp_path / "serial_blocks")}
    serial = lgt.train(params, lgt.Dataset(str(csv), params=params), rounds)
    gang = lgt.Booster(model_file=str(tmp_path / "gang.txt"))
    assert len(gang.gbdt.models) == len(serial.gbdt.models) == rounds
    assert [t.num_leaves for t in gang.gbdt.models] == \
        [t.num_leaves for t in serial.gbdt.models]

    def logloss(p):
        p = np.clip(p, 1e-15, 1 - 1e-15)
        return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))

    np.testing.assert_allclose(logloss(gang.predict(x)),
                               logloss(serial.predict(x)), rtol=1e-3)
