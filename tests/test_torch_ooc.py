"""lightgbm_tpu_torch out-of-core training on the CPU.

- the block store (lightgbm_tpu_torch/data/block_store.py): build,
  validation, reuse and every defect a truncated, bit-rotted or stale
  store shows (tests/test_out_of_core.py:90-300); a store the JAX
  package wrote opens in the port;
- the prefetcher (data/prefetch.py): order, padding, cache, residency
  and error propagation;
- the block fold (ops/hist_kernels.py hist_pair_fold, its plain version
  here): folding the blocks of an aligned split of the rows, then
  collapsing, equals masked_hist over the whole array bit for bit at 1,
  2 and 3 blocks, and matches the JAX package's hist_pair_fold_block +
  hist_pair_fold_collapse bit for bit in its segment formulation and to
  rtol 1e-6 in its default CPU one (the tolerance
  tests/test_torch_histogram.py holds the masked pair to);
- training: out-of-core model text equals the port's in-RAM masked
  model text (hist_compaction=false) byte for byte, on several blocks.
The oracle of the training cases is the port's own in-RAM run.
"""

import json
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data import (BlockPrefetcher, BlockStore,
                                     BlockStoreError, BlockStoreWriter,
                                     effective_block_rows,
                                     open_block_store_dataset,
                                     spill_core_dataset)
from lightgbm_tpu_torch.data.block_store import MANIFEST_NAME
from lightgbm_tpu_torch.io.dataset import DatasetLoader
from lightgbm_tpu_torch.ops import hist_kernels as hk
from lightgbm_tpu_torch.utils.log import LightGBMError

CPU = "cpu"
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
        "learning_rate": 0.1, "verbose": -1, "hist_compaction": "false",
        "device_row_chunk": 4096}
OOC = dict(BASE, out_of_core=True, block_rows=4096)
N_ROUNDS = 4


@pytest.fixture(autouse=True)
def _one_thread():
    # the plain histogram versions are many small CPU ops: one thread
    # each keeps the suite's parallel workers from oversubscribing
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(n=10000, f=8, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f)
    y = (x[:, 0] + 0.6 * x[:, 1] * x[:, 2] + 0.8 * rng.randn(n) > 0)
    return x, y.astype(np.float64)


def _write_csv(path, x, y):
    np.savetxt(path, np.column_stack([y, x]), delimiter=",", fmt="%.6f")


def _model(params, x, y, rounds=N_ROUNDS, **train_kw):
    return lgt.train(dict(params), lgt.Dataset(x, y, params=dict(params)),
                     rounds, verbose_eval=False, device=CPU, **train_kw)


def _text(booster):
    return booster.gbdt.save_model_to_string(-1)


# ===================================================== block store layer

def _tiny_store(directory, rows=100, feats=3, block_rows=32, seed=0):
    rng = np.random.RandomState(seed)
    cols = rng.randint(0, 200, size=(feats, rows)).astype(np.uint8)
    w = BlockStoreWriter(str(directory), feats, np.uint8, block_rows)
    for s, e in ((0, 10), (10, 45), (45, rows)):   # ragged appends
        w.append(cols[:, s:e])
    w.finish({"payload": np.arange(3)})
    return cols


def test_writer_reblocks_ragged_appends(tmp_path):
    cols = _tiny_store(tmp_path / "st")
    store = BlockStore.open(str(tmp_path / "st"))
    assert store.num_rows == 100
    assert [b["rows"] for b in store.blocks] == [32, 32, 32, 4]
    got = np.concatenate([store.read_block(i) for i in range(4)], axis=1)
    assert np.array_equal(got, cols)
    assert store.total_bytes() == sum(b["nbytes"] for b in store.blocks)
    assert np.array_equal(store.feature_rows(1, 2), cols[2, 32:64])


def _edit_manifest(d, **fields):
    m = json.load(open(d / MANIFEST_NAME))
    m.update(fields)
    json.dump(m, open(d / MANIFEST_NAME, "w"))


def _truncate_block(d):
    path = d / "block-00001.npy"
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-7])


@pytest.mark.parametrize("damage,match", [
    (lambda d: os.remove(d / MANIFEST_NAME), "no manifest.json"),
    (lambda d: _edit_manifest(d, magic="someone_elses_store"),
     "foreign magic"),
    (lambda d: _edit_manifest(d, format_version=99), "format 99"),
    (_truncate_block, "block-00001.npy.*truncated"),
    (lambda d: os.remove(d / "block-00002.npy"), "block-00002.npy.*does not"),
], ids=["missing_manifest", "foreign_magic", "future_version",
        "truncated_block", "missing_block"])
def test_open_names_the_defect(tmp_path, damage, match):
    d = tmp_path / "st"
    _tiny_store(d)
    damage(d)
    with pytest.raises(BlockStoreError, match=match):
        BlockStore.open(str(d))


def test_corrupt_block_detected_on_first_read(tmp_path):
    """Same-size bit rot passes open() and is caught by the crc32 on
    first read (and by reverify); ooc_verify=false skips the digest."""
    d = tmp_path / "st"
    _tiny_store(d)
    path = d / "block-00000.npy"
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    store = BlockStore.open(str(d))
    with pytest.raises(BlockStoreError, match="block-00000.npy is corrupt"):
        store.read_block(0)
    with pytest.raises(BlockStoreError, match="corrupt"):
        BlockStore.open(str(d), verify=False).reverify(0, 1)
    assert BlockStore.open(str(d), verify=False).read_block(0) is not None


def test_bitrot_between_attempts_caught_by_reverify(tmp_path, monkeypatch):
    """faults.bitrot_block_on_restart flips a block's byte on a
    restarted attempt only; the re-verification names the block."""
    from lightgbm_tpu_torch.utils import faults
    d = tmp_path / "st"
    _tiny_store(d)
    store = BlockStore.open(str(d))
    with faults.injected_faults(bitrot_block_on_restart=1):
        store.reverify(0, 4)                  # first attempt: no rot
        monkeypatch.setenv("LIGHTGBM_TPU_RESTART_ATTEMPT", "1")
        with pytest.raises(BlockStoreError, match="block-00001.npy is "
                           "corrupt"):
            store.reverify(0, 4)


def test_interrupted_build_leaves_no_manifest(tmp_path):
    d = tmp_path / "st"
    w = BlockStoreWriter(str(d), 3, np.uint8, 32)
    w.append(np.zeros((3, 40), np.uint8))   # one block flushed
    with pytest.raises(BlockStoreError, match="interrupted build"):
        BlockStore.open(str(d))
    _tiny_store(d)
    assert BlockStore.open(str(d)).num_rows == 100


def test_store_written_by_the_jax_package_opens(tmp_path):
    """The layout is the JAX package's: its spilled store opens in the
    port with the same bins, mappers and labels."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.data import spill_core_dataset as jspill
    from lightgbm_tpu.io.dataset import DatasetLoader as JLoader
    x, y = _data(n=700, f=5)
    core = JLoader(JConfig.from_params({"verbose": -1})) \
        .construct_from_matrix(x, label=y)
    jspill(core, str(tmp_path / "st"), 256)
    ds = open_block_store_dataset(str(tmp_path / "st"))
    assert ds.num_data == 700 and ds.block_store.num_blocks == 3
    assert np.array_equal(ds.materialize_in_ram().bins, core.bins)
    assert [m.num_bin for m in ds.bin_mappers] == \
        [m.num_bin for m in core.bin_mappers]
    np.testing.assert_array_equal(ds.metadata.label, core.metadata.label)


# ==================================================== prefetcher layer

def test_prefetcher_order_padding_and_stats(tmp_path):
    _tiny_store(tmp_path / "pst")
    store = BlockStore.open(str(tmp_path / "pst"))
    cols = np.concatenate([store.read_block(i) for i in range(4)], axis=1)
    # 100 data rows padded to 160: span 3 holds 4 data rows and 28
    # zeros, span 4 is all padding
    spans = [(0, 32, 32), (1, 32, 32), (2, 32, 32), (3, 32, 4),
             (None, 32, 0)]
    pf = BlockPrefetcher(store, spans, depth=2)
    for _ in range(2):   # two passes through the same ring
        got, row = [], 0
        for s, e, blk in pf.stream():
            assert (s, e) == (row, row + 32)
            got.append(blk.numpy().copy())
            row = e
        full = np.concatenate(got, axis=1)
        assert full.shape == (3, 160)
        assert np.array_equal(full[:, :100], cols) and not full[:, 100:].any()
    st = pf.stats()
    assert st["prefetch_blocks"] == 8
    assert st["prefetch_bytes"] == 2 * cols.nbytes
    pf.note_pass_wall(1.0)
    assert 0.0 <= pf.overlap_pct() <= 100.0
    # a consumer that leaves mid-pass drains the producer; the next
    # pass streams from the start
    for s, _, _ in pf.stream():
        break
    assert [s for s, _, _ in pf.stream()] == [0, 32, 64, 96, 128]


def test_prefetcher_cache_and_residency_bound(tmp_path):
    _tiny_store(tmp_path / "pst")
    store = BlockStore.open(str(tmp_path / "pst"))
    spans = [(i, 32, 32) for i in range(3)]
    pf = BlockPrefetcher(store, spans, depth=2, cache_blocks=3)
    list(pf.stream())
    first = pf.stats()["prefetch_bytes"]
    out = [b.numpy().copy() for _, _, b in pf.stream()]   # from the cache
    assert pf.stats()["prefetch_cache_hits"] == 3
    assert pf.stats()["prefetch_bytes"] == first
    want = np.concatenate([store.read_block(i) for i in range(3)], axis=1)
    assert np.array_equal(np.concatenate(out, 1), want)
    assert pf.resident_bytes() == 3 * 32 * (2 + 3)   # ring + cache (CPU)


def test_prefetcher_propagates_reader_errors(tmp_path):
    _tiny_store(tmp_path / "pst")
    store = BlockStore.open(str(tmp_path / "pst"))
    pf = BlockPrefetcher(store, [(0, 32, 32), (1, 32, 31)], depth=1)
    with pytest.raises(RuntimeError, match="span plan"):
        list(pf.stream())


# ============================================== dataset container layer

def test_spill_roundtrip_block_view_and_guardrails(tmp_path):
    x, y = _data(n=700, f=5)
    core = DatasetLoader(Config.from_params({"verbose": -1})) \
        .construct_from_matrix(x, label=y)
    ds = spill_core_dataset(core, str(tmp_path / "st"), 128)
    assert ds.num_data == 700 and ds.block_store.num_blocks == 6
    assert ds.stored_bins_dtype == core.bins.dtype
    rng = np.random.RandomState(0)
    feats, rows = rng.randint(0, 5, 200), rng.randint(0, 700, 200)
    assert np.array_equal(ds.traversal_bins()[feats, rows],
                          core.bins[feats, rows].astype(np.int64))
    assert np.array_equal(ds.materialize_in_ram().bins, core.bins)
    with pytest.raises(LightGBMError, match="no resident bin matrix"):
        ds.device_bins(CPU)
    with pytest.raises(LightGBMError, match="subset"):
        ds.subset(np.arange(10))
    with pytest.raises(LightGBMError, match="already is the binary form"):
        ds.save_binary(str(tmp_path / "x.bin"))
    from lightgbm_tpu_torch.models.tree_learner import SerialTreeLearner
    with pytest.raises(LightGBMError, match="out_of_core=true"):
        SerialTreeLearner(Config.from_params(dict(BASE)), CPU).init(ds)


def test_file_store_reuse_and_signature_rebuild(tmp_path):
    x, y = _data(n=900, f=5)
    data = str(tmp_path / "t.csv")
    _write_csv(data, x, y)
    cfg = Config.from_params(dict(OOC))
    ds1 = DatasetLoader(cfg).load_from_file(data)
    manifest = os.path.join(data + ".blocks", MANIFEST_NAME)
    stamp = os.path.getmtime(manifest)
    ds2 = DatasetLoader(cfg).load_from_file(data)    # same signature
    assert os.path.getmtime(manifest) == stamp
    assert np.array_equal(ds1.metadata.label, ds2.metadata.label)
    ds3 = DatasetLoader(Config.from_params(dict(OOC, max_bin=63))) \
        .load_from_file(data)                       # binning changed
    assert os.path.getmtime(manifest) != stamp
    assert ds3.block_store.manifest["binning"]["max_bin"] == 63
    assert ds3.block_store.manifest["build_count"] == 2
    _write_csv(data, x[:800], y[:800])              # the file changed
    assert DatasetLoader(cfg).load_from_file(data).num_data == 800


def test_block_rows_round_up_to_both_grids():
    """Up to a multiple of HIST_CHUNK (4096) and device_row_chunk."""
    assert effective_block_rows(Config.from_params(
        dict(OOC, block_rows=300))) == 4096
    assert effective_block_rows(Config.from_params(
        dict(OOC, block_rows=300, device_row_chunk=256))) == 4096
    assert effective_block_rows(Config.from_params(
        {"block_rows": 70000})) == 81920            # 5 x 16384


# ======================================================= the block fold

def _fold_inputs(b, dtype, seed, n_chunks=3, signed=True):
    rng = np.random.RandomState(seed)
    f, n = 5, n_chunks * hk.HIST_CHUNK
    bins = rng.randint(0, b, size=(f, n)).astype(dtype)
    inbag = (rng.rand(n) < 0.8).astype(np.float32)
    g = rng.randn(n) if signed else rng.rand(n)
    ghc = np.stack([g.astype(np.float32) * inbag,
                    rng.rand(n).astype(np.float32) * inbag, inbag])
    row_leaf = rng.randint(0, 4, size=n).astype(np.int32)
    return bins, ghc, row_leaf


def _fold_blocks(bins, ghc, row_leaf, leaf, b, bounds):
    f = bins.shape[0]
    acc = torch.zeros((f, b, 3))
    comp = torch.zeros((f, b, 3))
    tb, tg, tr = (torch.from_numpy(np.ascontiguousarray(a))
                  for a in (bins, ghc, row_leaf))
    lid = torch.tensor([leaf], dtype=torch.int32)
    for s, e in zip(bounds[:-1], bounds[1:]):
        hk.hist_pair_fold(acc, comp, tb[:, s:e].contiguous(),
                          tg[:, s:e].contiguous(), tr[s:e], lid, b)
    return acc, comp


CASES = [pytest.param(16, np.uint8, id="uint8-B16"),
         pytest.param(300, np.int16, id="int16-B300")]


@pytest.mark.parametrize("blocks", [1, 2, 3])
@pytest.mark.parametrize("b,dtype", CASES)
def test_block_fold_equals_masked_hist_bitwise(b, dtype, blocks):
    """Blocks of whole chunks at any aligned split (one, two uneven, or
    three), folded in row order and collapsed: masked_hist over the
    whole array, bit for bit."""
    bins, ghc, rl = _fold_inputs(b, dtype, blocks)
    c = hk.HIST_CHUNK
    bounds = {1: [0, 3 * c], 2: [0, c, 3 * c], 3: [0, c, 2 * c, 3 * c]}[blocks]
    for leaf in (0, 3):
        acc, comp = _fold_blocks(bins, ghc, rl, leaf, b, bounds)
        got = hk.hist_pair_collapse(acc, comp)
        hi, lo = hk.masked_hist_plain(
            *(torch.from_numpy(a) for a in (bins, ghc, rl)),
            torch.tensor([leaf], dtype=torch.int32), b)
        assert torch.equal(got.view(torch.int32), (hi + lo).view(torch.int32))


@pytest.mark.parametrize("b,dtype", CASES)
def test_block_fold_matches_jax_hist_pair_fold_block(b, dtype):
    """Against lightgbm_tpu.ops.histogram hist_pair_fold_block
    (row_chunk=4096) + hist_pair_fold_collapse over the same blocks, the
    leaf mask folded into the statistics as the JAX out-of-core learner
    does: bit for bit in the segment formulation (float32 row-order
    sums, callbacks_disabled), rtol 1e-6 in the default CPU one, on
    non-negative statistics."""
    import jax.numpy as jnp
    from lightgbm_tpu.ops.histogram import (callbacks_disabled,
                                            hist_pair_fold_block,
                                            hist_pair_fold_collapse)
    bins, ghc, rl = _fold_inputs(b, dtype, 7, signed=False)
    c = hk.HIST_CHUNK
    bounds = [0, c, 3 * c]
    leaf = 2
    acc, comp = _fold_blocks(bins, ghc, rl, leaf, b, bounds)
    got = hk.hist_pair_collapse(acc, comp).numpy()

    def jax_fold():
        ja = jnp.zeros((bins.shape[0], b, 3), jnp.float32)
        jc = jnp.zeros_like(ja)
        for s, e in zip(bounds[:-1], bounds[1:]):
            mask = (rl[s:e] == leaf).astype(np.float32)
            ja, jc = hist_pair_fold_block(
                ja, jc, jnp.asarray(bins[:, s:e]),
                jnp.asarray((ghc[:, s:e] * mask).T), b, row_chunk=c)
        return np.asarray(hist_pair_fold_collapse(ja, jc))

    with callbacks_disabled():
        np.testing.assert_array_equal(got, jax_fold())
    np.testing.assert_allclose(got, jax_fold(), rtol=1e-6)


# ===================================================== training parity

@pytest.mark.parametrize("extra", [
    {},
    {"bagging_fraction": 0.6, "bagging_freq": 2, "feature_fraction": 0.7},
    {"boosting": "goss", "top_rate": 0.3, "other_rate": 0.2},
    {"boosting": "dart", "drop_rate": 0.3, "drop_seed": 9},
    {"linear_tree": True},
    {"histogram_pool_size": 0.001},
], ids=["binary", "bagging-ff", "goss", "dart", "linear", "cacheless"])
def test_model_text_equals_in_ram_masked(extra):
    """Three blocks of 4096 rows (the last short, padded to the in-RAM
    N_pad): the same model text, and the same predictions. The
    cache-less case streams both children in one frontier pass."""
    x, y = _data()
    ref = _model(dict(BASE, **extra), x, y)
    got = _model(dict(OOC, **extra), x, y)
    learner = got.gbdt.tree_learner
    assert learner.name == "out_of_core"
    assert learner.train_set.block_store.num_blocks == 3
    assert learner.stats()["prefetch_blocks"] > 0
    assert _text(got) == _text(ref)
    assert np.array_equal(ref.predict(x), got.predict(x))


def test_multiclass_model_text_equals_in_ram_masked():
    x, _ = _data(n=9000)
    y = np.digitize(x[:, 0], [-0.5, 0.5]).astype(np.float64)
    extra = {"objective": "multiclass", "num_class": 3}
    ref = _model(dict(BASE, **extra), x, y, rounds=3)
    got = _model(dict(OOC, **extra), x, y, rounds=3)
    assert _text(got) == _text(ref)


def test_valid_set_and_early_stopping_equal_in_ram_masked():
    """Valid sets stay in RAM, binned with the out-of-core train set's
    mappers; the stop and the eval history come out the same (the
    in-RAM run goes blockwise, the out-of-core one per iteration)."""
    x, y = _data()
    xt, yt, xv, yv = x[:8500], y[:8500], x[8500:], y[8500:]
    out = {}
    for name, params in (("ref", BASE), ("ooc", OOC)):
        p = dict(params, metric="binary_logloss")
        train = lgt.Dataset(xt, yt, params=p)
        valid = lgt.Dataset(xv, yv, reference=train, params=p)
        er = {}
        b = lgt.train(p, train, 8, valid_sets=[valid],
                      early_stopping_rounds=3, evals_result=er,
                      verbose_eval=False, device=CPU)
        out[name] = (_text(b), b.best_iteration, er)
    assert out["ooc"][:2] == out["ref"][:2]
    np.testing.assert_allclose(out["ooc"][2]["valid_0"]["binary_logloss"],
                               out["ref"][2]["valid_0"]["binary_logloss"],
                               rtol=1e-6)


def test_file_route_equals_in_ram_masked(tmp_path):
    """A CSV binned straight into the store next to it (two-round
    streaming, never a matrix) trains to the in-RAM load's model."""
    x, y = _data(n=9000)
    data = str(tmp_path / "t.csv")
    _write_csv(data, x, y)
    ref = lgt.train(dict(BASE), lgt.Dataset(data, params=dict(BASE)),
                    N_ROUNDS, device=CPU)
    got = lgt.train(dict(OOC), lgt.Dataset(data, params=dict(OOC)),
                    N_ROUNDS, device=CPU)
    assert os.path.exists(os.path.join(data + ".blocks", MANIFEST_NAME))
    assert got.gbdt.tree_learner.train_set.block_store.num_blocks == 3
    assert _text(got) == _text(ref)
