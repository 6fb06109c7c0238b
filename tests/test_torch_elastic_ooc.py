"""lightgbm_tpu_torch's out-of-core gang learner against lightgbm_tpu's, on
the CPU (data/ooc_parallel.py, the gang parts of data/block_store.py,
the `stale_ownership` fault).

Held here:
- the gang views of a shared store (gang_view_of) cut the same block
  and row ranges as the JAX function, at W = 1 to 4, with the same
  labels and local traversal rows;
- `stale_ownership` widens the armed rank's world as the JAX fault
  does, and the cross-rank tiling check refuses the lease; a peer that
  finds no store built by rank 0 gives up after ooc_build_wait_s;
- a one-rank gang gives the serial out-of-core learner's bits;
- the gang's exchange (ProcessMesh.fold_exchange of every rank's
  (acc, -comp)) is bit-equal to the JAX package's kahan_fold of the
  same 2W words, on the LocalMesh (whose fold order the ProcessMesh
  keeps bit for bit, tests/test_torch_distributed.py) and on the words
  of real per-rank carries;
- a 2-rank gloo gang (two CLI processes over one shared store): its
  trees equal the JAX package's gang learner's (run here as two threads
  whose process all-gather is a barrier exchange: a JAX process group
  cannot run in this sandbox), structure and leaves within LEAF_TOL; and
  against the JAX package's serial out-of-core learner, the port's gang
  parts exactly where the JAX gang does. The two fold orders differ in
  the last bit of a few histogram cells, so a near-tie split can part
  (ROADMAP queue 3): the bound on that spread is the JAX package's own
  gang-against-serial spread. Its journal holds one block_reshard record
  a rank, the ranges tiling the store, and the iterations' collective
  bytes.
"""

import json
import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax
import lightgbm_tpu as lgj
import lightgbm_tpu.data.ooc_parallel as jop
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.block_store import gang_view_of as jgang_view_of
from lightgbm_tpu.data.block_store import \
    load_or_build_block_store as jload_store
from lightgbm_tpu.data.block_store import spill_core_dataset as jspill
from lightgbm_tpu.io.dataset import DatasetLoader as JLoader
from lightgbm_tpu.models.gbdt import create_boosting as jcreate_boosting
from lightgbm_tpu.objectives import create_objective as jcreate_objective
from lightgbm_tpu.parallel import mesh as jmesh
from lightgbm_tpu.utils import faults as jfaults

from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data.block_store import (BlockStoreError,
                                                 gang_view_of,
                                                 load_block_store_gang,
                                                 spill_core_dataset)
from lightgbm_tpu_torch.data.ooc_learner import OutOfCoreTreeLearner
from lightgbm_tpu_torch.data.ooc_parallel import OutOfCoreGangLearner
from lightgbm_tpu_torch.io.dataset import DatasetLoader
from lightgbm_tpu_torch.ops import hist_kernels as hk
from lightgbm_tpu_torch.parallel import mesh as tmesh
from lightgbm_tpu_torch.parallel.machines import check_block_tiling
from lightgbm_tpu_torch.telemetry import journal as tjournal
from lightgbm_tpu_torch.utils import faults

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEAF_TOL = 1e-6
OOC = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
       "verbose": -1, "hist_compaction": "false", "device_row_chunk": 4096,
       "out_of_core": True, "block_rows": 4096}
GANG_ROUNDS = 6
GANG_ARGS = ["task=train", "objective=binary", "num_leaves=7",
             f"num_iterations={GANG_ROUNDS}", "out_of_core=true",
             "block_rows=4096", "device_row_chunk=4096",
             "hist_compaction=false", "min_data_in_leaf=10", "metric_freq=0",
             "enable_load_from_binary_file=false", "verbose=1"]
# the CLI on the CPU in a fresh process (tests/test_torch_ooc_resume.py)
CLI_ON_CPU = ("import sys, torch; torch.set_num_threads(1); "
              "from lightgbm_tpu_torch.application import Application; "
              "Application(sys.argv[1:], device='cpu').run()")


@pytest.fixture(autouse=True)
def _one_thread_no_faults():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.clear_faults()
    jfaults.clear_faults()
    yield
    faults.clear_faults()
    jfaults.clear_faults()
    faults._rank = None
    jfaults._rank = None
    torch.set_num_threads(threads)


def _data(n=9000, f=6, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f)
    y = (x[:, 0] + 0.6 * x[:, 1] * x[:, 2] + 0.8 * rng.randn(n) > 0)
    return x, y.astype(np.float64)


def _spilled(tmp_path, tag, pkg_loader, spill, config, n=9000):
    x, y = _data(n=n)
    core = pkg_loader(config({"verbose": -1})).construct_from_matrix(
        x, label=y)
    return spill(core, str(tmp_path / tag), 4096)


# ------------------------------------------------------------ gang views

@pytest.mark.parametrize("w", [1, 2, 3, 4])
def test_gang_views_cut_the_jax_ranges(tmp_path, w):
    tds = _spilled(tmp_path, "t", DatasetLoader, spill_core_dataset,
                   Config.from_params)
    jds = _spilled(tmp_path, "j", JLoader, jspill, JConfig.from_params)
    labels = []
    for r in range(w):
        tv, jv = gang_view_of(tds, r, w), jgang_view_of(jds, r, w)
        assert (tv.block_lo, tv.block_hi, tv.row_lo, tv.row_hi,
                tv.num_data, tv.global_num_data, tv.gang_rank,
                tv.gang_world) == (jv.block_lo, jv.block_hi, jv.row_lo,
                                   jv.row_hi, jv.num_data,
                                   jv.global_num_data, jv.gang_rank,
                                   jv.gang_world)
        np.testing.assert_array_equal(tv.metadata.label, jv.metadata.label)
        labels.append(tv.metadata.label)
        if tv.num_data:
            rows = np.arange(0, tv.num_data, 97)
            feats = rows % tv.num_features
            np.testing.assert_array_equal(tv.traversal_bins()[feats, rows],
                                          jv.traversal_bins()[feats, rows])
    np.testing.assert_array_equal(np.concatenate(labels),
                                  tds.metadata.label)


def test_gang_view_walks_its_owned_rows(tmp_path):
    """A gang view's host walk of stacked trees (the truncation and
    rollback subtraction of its train score) gives the whole store's
    walk at its own rows."""
    ds = _spilled(tmp_path, "t", DatasetLoader, spill_core_dataset,
                  Config.from_params)
    rng = np.random.RandomState(1)
    m, s = 3, 5
    sf = rng.randint(0, ds.num_features, (m, s)).astype(np.int32)
    thr = rng.randint(0, 200, (m, s)).astype(np.int32)
    # node i splits into 2i+1, 2i+2; past the last node, leaves
    kids = np.arange(s)[None, :].repeat(m, 0)
    lc = np.where(2 * kids + 1 < s, 2 * kids + 1, ~kids).astype(np.int32)
    rc = np.where(2 * kids + 2 < s, 2 * kids + 2, ~(kids + 1)).astype(
        np.int32)
    n_splits = np.array([s, 2, 0])
    whole = ds.stacked_leaves(sf, thr, lc, rc, n_splits, 3)
    for r in range(3):
        v = gang_view_of(ds, r, 3)
        np.testing.assert_array_equal(
            v.stacked_leaves(sf, thr, lc, rc, n_splits, 3),
            whole[:, v.row_lo:v.row_hi])


def test_stale_ownership_breaks_the_tiling(tmp_path):
    ds = _spilled(tmp_path, "t", DatasetLoader, spill_core_dataset,
                  Config.from_params, n=20000)      # 5 blocks
    for mod in (faults, jfaults):
        mod.set_rank(1)
        assert mod.stale_ownership_world(2) == 2
        for armed, want in ((1, 3), (0, 2), (-1, 3)):
            with mod.injected_faults(stale_ownership=armed):
                assert mod.stale_ownership_world(2) == want
    faults.set_rank(1)
    with faults.injected_faults(stale_ownership=1):
        stale = gang_view_of(ds, 1, 2)   # derived from a world of 3
    fresh = gang_view_of(ds, 0, 2)
    with pytest.raises(ValueError, match="stale block-ownership lease"):
        check_block_tiling([(fresh.block_lo, fresh.block_hi),
                            (stale.block_lo, stale.block_hi)],
                           ds.block_store.num_blocks)


def test_gang_peer_gives_up_without_rank0_build(tmp_path):
    cfg = Config.from_params(dict(OOC, ooc_build_wait_s=0.3,
                                  ooc_dir=str(tmp_path / "never")))
    t0 = time.monotonic()
    with pytest.raises(BlockStoreError, match="ooc_build_wait_s"):
        load_block_store_gang(DatasetLoader(cfg),
                              str(tmp_path / "absent.csv"), 1, 2)
    assert time.monotonic() - t0 < 10.0


def test_one_rank_gang_gives_the_serial_learner_bits(tmp_path):
    ds = _spilled(tmp_path, "t", DatasetLoader, spill_core_dataset,
                  Config.from_params)
    cfg = Config.from_params(dict(OOC))
    rng = np.random.RandomState(7)
    g = torch.from_numpy(rng.randn(ds.num_data).astype(np.float32))
    h = torch.from_numpy((rng.rand(ds.num_data) + 0.2).astype(np.float32))
    serial = OutOfCoreTreeLearner(cfg, CPU)
    serial.init(ds)
    want = serial.train_device(g, h)
    gang = OutOfCoreGangLearner(cfg, CPU)
    gang.init(gang_view_of(ds, 0, 1))
    assert (gang._blk_lo, gang._blk_hi) == (0, ds.block_store.num_blocks)
    assert gang._gang_shape() == (1, 0) and gang.mesh is None
    got = gang.train_device(g, h)
    for key in want:
        assert torch.equal(want[key], got[key]), key


# ------------------------------------------------------------ exchange

@pytest.mark.parametrize("w", [2, 3])
def test_gang_exchange_equals_jax_kahan_fold(w):
    rng = np.random.RandomState(w)
    shape = (2, 7, 33, 3)
    # carries: large values with small residuals, as a pass leaves them
    acc = [torch.from_numpy((rng.randn(*shape) * 1e3).astype(np.float32))
           for _ in range(w)]
    comp = [torch.from_numpy((rng.randn(*shape) * 1e-4).astype(np.float32))
            for _ in range(w)]
    mesh = tmesh.LocalMesh(w, CPU)
    got = mesh.run(lambda r: tmesh.pair_allreduce((acc[r], -comp[r]),
                                                  mesh))
    words = np.stack([a.numpy() for a in acc]
                     + [(-c).numpy() for c in comp])
    want = np.asarray(jmesh.kahan_fold(words))
    for r in range(w):
        np.testing.assert_array_equal(got[r].numpy(), want)


def test_gang_exchange_of_real_carries_equals_jax(tmp_path):
    """Each rank's carry over its owned blocks (hist_pair_fold), then
    the exchange: the JAX fold of the same words, bit for bit; its cells
    part from the serial carry's collapse by at most an ulp."""
    rng = np.random.RandomState(0)
    f, b, n = 5, 64, 3 * hk.HIST_CHUNK
    bins = torch.from_numpy(rng.randint(0, b, (f, n)).astype(np.uint8))
    ghc = torch.from_numpy(np.stack([rng.randn(n), rng.rand(n) + 0.2,
                                     np.ones(n)]).astype(np.float32))
    row_leaf = torch.zeros(n, dtype=torch.int32)
    leaf = torch.zeros(1, dtype=torch.int32)

    def carry(lo, hi):
        acc, comp = torch.zeros((f, b, 3)), torch.zeros((f, b, 3))
        for s in range(lo, hi, hk.HIST_CHUNK):
            e = s + hk.HIST_CHUNK
            hk.hist_pair_fold(acc, comp, bins[:, s:e].contiguous(),
                              ghc[:, s:e].contiguous(), row_leaf[s:e],
                              leaf, b)
        return acc, comp

    parts = [carry(0, 2 * hk.HIST_CHUNK), carry(2 * hk.HIST_CHUNK, n)]
    mesh = tmesh.LocalMesh(2, CPU)
    got = mesh.run(lambda r: tmesh.pair_allreduce(
        (parts[r][0], -parts[r][1]), mesh))[0].numpy()
    words = np.stack([p[0].numpy() for p in parts]
                     + [(-p[1]).numpy() for p in parts])
    np.testing.assert_array_equal(got, np.asarray(jmesh.kahan_fold(words)))
    acc, comp = carry(0, n)
    serial = (acc - comp).numpy()
    # both are within an ulp or two of the exact sum of each cell
    bn = bins.numpy()
    vals = np.abs(ghc.numpy()).astype(np.float64)
    mag = np.stack([np.stack([np.bincount(bn[j], weights=vals[k],
                                          minlength=b) for k in range(3)],
                             axis=-1) for j in range(f)])
    assert (np.abs(got.astype(np.float64) - serial) <= 2 ** -22 * mag).all()
    assert (got != serial).any()   # the fold orders part in the last bit


# ------------------------------------------------------- the 2-rank gang

def _write_csv(path, n=10000, f=5, seed=11):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, f)
    y = ((x[:, 0] + x[:, 1] * x[:, 2]) > 0.9).astype(int)
    np.savetxt(path, np.column_stack([y, x]), delimiter=",", fmt="%.6f")


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(argvs, envs, cwd, timeout=240):
    """One CLI_ON_CPU process a rank (LIGHTGBM_TPU_RANK=r plus envs[r]);
    [(returncode, output)] in rank order. Every process ends with the
    call."""
    procs = []
    for r, (argv, env) in enumerate(zip(argvs, envs)):
        e = dict(os.environ, LIGHTGBM_TPU_RANK=str(r), PYTHONPATH=REPO,
                 OMP_NUM_THREADS="1")
        e.pop("LIGHTGBM_TPU_FAULTS", None)
        e.pop("LIGHTGBM_TPU_RESTART_ATTEMPT", None)
        e.update(env or {})
        procs.append(subprocess.Popen(argv, env=e, cwd=cwd,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    out = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
            text += "\n<TIMEOUT KILL>"
        out.append((p.returncode, text))
    return out


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """One 2-rank gloo gang over the shared store of a 10,000-row CSV
    (3 blocks: rank 0 owns 2, rank 1 one)."""
    d = tmp_path_factory.mktemp("ooc_gang")
    _write_csv(d / "tr.csv")
    port = _free_port()
    (d / "mlist.txt").write_text(f"127.0.0.1 {port}\n127.0.0.1 {port + 1}\n")
    argv = ([sys.executable, "-c", CLI_ON_CPU] + GANG_ARGS + [
        f"data={d / 'tr.csv'}", "tree_learner=data", "num_machines=2",
        f"machine_list_file={d / 'mlist.txt'}", "telemetry=true",
        f"snapshot_dir={d / 'snaps'}", f"output_model={d / 'model.txt'}"])
    res = run_ranks([argv, argv], [None, None], str(d))
    for r, (rc, text) in enumerate(res):
        assert rc == 0, f"rank {r} failed:\n{text[-4000:]}"
    return d, res


def _jax_gang(csv, w, ooc_dir):
    """The JAX package's gang learner on W threads, its process
    all-gather a barrier exchange between them; rank 0's model text."""
    params = {"objective": "binary", "num_leaves": 7,
              "min_data_in_leaf": 10, "hist_compaction": "false",
              "device_row_chunk": 4096, "out_of_core": True,
              "block_rows": 4096, "ooc_dir": ooc_dir, "verbose": -1,
              "enable_load_from_binary_file": False, "metric_freq": 0,
              "tree_learner": "data", "num_machines": w}
    ds = jload_store(JLoader(JConfig.from_params(dict(params))), csv)
    slots, barrier, local = [None] * w, threading.Barrier(w), \
        threading.local()

    def allgather(x):
        slots[local.rank] = np.asarray(x)
        barrier.wait()
        out = np.stack(slots)
        barrier.wait()
        return out

    models, errors = [None] * w, []

    def run(r):
        local.rank = r
        try:
            cfg = JConfig.from_params(dict(params))
            view = jgang_view_of(ds, r, w)
            obj = jcreate_objective(cfg.objective, cfg)
            obj.init(view.metadata, view.num_data)
            booster = jcreate_boosting("gbdt")
            booster.init(cfg, view, obj, [])
            for _ in range(GANG_ROUNDS):
                booster.train_one_iter(is_eval=False)
            models[r] = booster.save_model_to_string(-1)
        except BaseException as e:   # reported in the caller
            errors.append(e)
            barrier.abort()

    saved = jop._process_allgather, jop.jax
    jop._process_allgather = allgather
    jop.jax = types.SimpleNamespace(process_count=lambda: w,
                                    block_until_ready=jax.block_until_ready)
    try:
        threads = [threading.Thread(target=run, args=(r,))
                   for r in range(w)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        jop._process_allgather, jop.jax = saved
    assert not errors, errors
    assert len(set(models)) == 1
    return models[0]


def _trees(text):
    from lightgbm_tpu_torch.models.gbdt import create_boosting
    booster = create_boosting("gbdt", CPU)
    booster.load_model_from_string(text)
    return booster.models


STRUCTURE = ("split_feature_real", "threshold", "left_child",
             "right_child", "leaf_count", "internal_count")


def _same_structure(a, b):
    return a.num_leaves == b.num_leaves and all(
        np.array_equal(getattr(a, k), getattr(b, k)) for k in STRUCTURE)


def test_two_rank_gang_equals_the_jax_gang_and_its_serial_spread(gang):
    d, _ = gang
    csv = str(d / "tr.csv")
    port = _trees((d / "model.txt").read_text())
    jax_gang = _trees(_jax_gang(csv, 2, str(d / "jax_blocks")))
    params = {"objective": "binary", "num_leaves": 7,
              "min_data_in_leaf": 10, "hist_compaction": "false",
              "device_row_chunk": 4096, "out_of_core": True,
              "block_rows": 4096, "ooc_dir": str(d / "jax_serial_blocks"),
              "verbose": -1, "enable_load_from_binary_file": False,
              "metric_freq": 0}
    serial = _trees(lgj.train(dict(params), lgj.Dataset(
        csv, params=dict(params)), GANG_ROUNDS).gbdt.save_model_to_string(-1))
    assert len(port) == len(jax_gang) == len(serial) == GANG_ROUNDS
    for a, b in zip(jax_gang, port):
        assert _same_structure(a, b)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=0,
                                   atol=LEAF_TOL)
    # against the serial learner: the port's gang parts where the JAX
    # gang parts, and its leaves stay within the JAX gang's spread
    for i, (s, j, p) in enumerate(zip(serial, jax_gang, port)):
        assert _same_structure(s, p) == _same_structure(s, j), i
        if _same_structure(s, j):
            spread = np.max(np.abs(j.leaf_value - s.leaf_value))
            np.testing.assert_allclose(p.leaf_value, s.leaf_value, rtol=0,
                                       atol=spread + LEAF_TOL)


def test_two_rank_gang_journals_its_blocks_and_bytes(gang):
    d, res = gang
    recs, bad = tjournal.read_journal(d / "snaps" / "journal.jsonl")
    assert bad == 0
    reshard = sorted((r for r in recs if r["event"] == "block_reshard"),
                     key=lambda r: r["rank"])
    assert [(r["rank"], r["shards"], r["block_lo"], r["block_hi"])
            for r in reshard] == [(0, 2, 0, 2), (1, 2, 2, 3)]
    assert all(r["learner"] == "out_of_core_gang" and r["attempt"] == 0
               for r in reshard)
    assert not any(r["event"] == "binning" for r in recs)
    its = [r for r in recs if r["event"] == "iteration" and r["rank"] == 0]
    assert len(its) == GANG_ROUNDS
    # one pair all-gather a pass: the root and one a split, 7 leaves
    per_pass = 2 * 5 * 256 * 3 * 4
    bytes_ = [r["collective_bytes"]["hist_reduce"] for r in its]
    assert bytes_ == [per_pass * 7] * GANG_ROUNDS, bytes_
    assert all(r["prefetch_bytes"] > 0 for r in its)
    for rc, text in res:
        assert "ranks hold the same model" in text
    with open(d / "tr.csv.blocks" / "manifest.json") as f:
        assert json.load(f)["build_count"] == 1
