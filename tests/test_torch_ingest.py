"""lightgbm_tpu_torch's data ingestion against lightgbm_tpu.

Each case runs the JAX loader and the port's on the same files, written
here with at most 9 significant digits (where pandas' float parser, the
JAX package's, rounds correctly: ROADMAP queue 3), and holds bins,
mappers and metadata equal: the parser on CSV/TSV with and without a
header and on LibSVM, NA tokens and empty fields; label, weight, group,
ignore and categorical columns by index and by `name:`; the side files;
the max_bad_rows quarantine; two-round loading; wide LibSVM streaming;
aligned valid files; the binary cache crossing packages both ways, and
a rotten cache. A 17-digit file checks that the port parses every value
as Python's float() does.
"""

import re

import numpy as np
import pytest
import scipy.sparse as sp

import lightgbm_tpu as lgj
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io import parser as jparser
from lightgbm_tpu.io.dataset import (BinaryDatasetError as JBinaryError,
                                     CoreDataset as JCore,
                                     DatasetLoader as JLoader)
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io import parser as tparser
from lightgbm_tpu_torch.io.dataset import (BinaryDatasetError as TBinaryError,
                                           CoreDataset as TCore,
                                           DatasetLoader as TLoader)
from lightgbm_tpu.utils.log import Log as JLog
from lightgbm_tpu_torch.utils.log import LightGBMError, Log as TLog

CPU = "cpu"
N = 600


@pytest.fixture
def warnings_shown(monkeypatch):
    """Both packages' loggers at warning level (a verbose=-1 config
    earlier in the process silences them)."""
    for log in (JLog, TLog):
        monkeypatch.setattr(log, "_level", 0)
NA_TOKENS = ["NA", "", "nan", "null", "NaN", "na", "N/A"]
NAMES = ["y", "a", "b", "cat", "d", "e", "f", "wt", "qid"]


def _table(seed=1, n=N):
    """(label, features) of the files: a categorical column (2), a
    weight column (6) and a query-id column (7)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 8)
    x[:, 1] = np.round(x[:, 1] * 2)
    x[:, 2] = rng.randint(0, 6, n)
    x[rng.rand(n) < 0.2, 3] = 0.0
    x[:, 6] = rng.rand(n) + 0.5
    x[:, 7] = np.repeat(np.arange(n // 10), 10)
    y = (x[:, 0] + 0.3 * rng.randn(n) > 0).astype(int)
    return y, x


def _write_text(path, y, x, sep, header, na_every=0):
    with open(path, "w") as f:
        if header:
            f.write(sep.join(NAMES) + "\n")
        for i in range(len(y)):
            toks = [str(y[i])]
            for j, v in enumerate(x[i]):
                if na_every and j in (0, 3) and (i + j) % na_every == 0:
                    toks.append(NA_TOKENS[(i + j) % len(NA_TOKENS)])
                else:
                    toks.append("%.9g" % v)
            f.write(sep.join(toks) + "\n")


def _write_libsvm(path, y, x, offset=0):
    with open(path, "w") as f:
        for i in range(len(y)):
            toks = [str(y[i])] + [f"{j + offset}:{v:.9g}"
                                  for j, v in enumerate(x[i]) if v != 0.0]
            f.write(" ".join(toks) + "\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ingest")
    y, x = _table()
    out = {}
    for name, sep, header, na in (("csv", ",", False, 0),
                                  ("csv_header", ",", True, 0),
                                  ("tsv", "\t", False, 7),
                                  ("tsv_header", "\t", True, 5)):
        out[name] = str(d / f"{name}.txt")
        _write_text(out[name], y, x, sep, header, na)
    out["libsvm"] = str(d / "train.svm")
    _write_libsvm(out["libsvm"], y, x[:, :6])
    yv, xv = _table(seed=2, n=200)
    out["valid_tsv"] = str(d / "valid.tsv")
    _write_text(out["valid_tsv"], yv, xv, "\t", True)
    out["valid_svm"] = str(d / "valid.svm")
    _write_libsvm(out["valid_svm"], yv, xv[:, :6])
    out["dir"] = d
    return out


def _cfg(params):
    params = dict(params, verbose=-1)
    return JConfig.from_params(params), TConfig.from_params(params)


def _same_core(j, t):
    assert (t.bundle_plan is None) == (j.bundle_plan is None)
    if j.bundle_plan is not None:
        for k, v in j.bundle_plan.to_dict().items():
            np.testing.assert_array_equal(t.bundle_plan.to_dict()[k], v)
    assert t.bins.dtype == j.bins.dtype
    np.testing.assert_array_equal(np.asarray(t.bins), np.asarray(j.bins))
    np.testing.assert_array_equal(t.real_feature_idx, j.real_feature_idx)
    np.testing.assert_array_equal(t.used_feature_map, j.used_feature_map)
    assert list(t.feature_names) == list(j.feature_names)
    assert t.num_total_features == j.num_total_features
    assert t.label_idx == j.label_idx
    assert len(t.bin_mappers) == len(j.bin_mappers)
    for mt, mj in zip(t.bin_mappers, j.bin_mappers):
        dt, dj = mt.to_dict(), mj.to_dict()
        assert dt.keys() == dj.keys()
        for k in dt:
            np.testing.assert_array_equal(np.asarray(dt[k]),
                                          np.asarray(dj[k]), err_msg=k)
    for k in ("label", "weights", "query_boundaries", "init_score"):
        a, b = getattr(t.metadata, k), getattr(j.metadata, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=k)


def _load_both(path, params):
    jc, tc = _cfg(params)
    return JLoader(jc).load_from_file(path), TLoader(tc).load_from_file(path)


# ------------------------------------------------------------------ parser

@pytest.mark.parametrize("name", ["csv", "csv_header", "tsv", "tsv_header",
                                  "libsvm"])
def test_parser_matches_jax(files, name):
    header = name.endswith("header")
    want = jparser.parse_text_file(files[name], has_header=header)
    got = tparser.parse_text_file(files[name], has_header=header)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].dtype == want[1].dtype == np.float64
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:]
    assert tparser.detect_format(files[name]) == \
        jparser.detect_format(files[name])


@pytest.mark.parametrize("keep_nan", [False, True])
def test_chunked_parse_matches_jax(files, keep_nan):
    for name in ("tsv_header", "libsvm"):
        kw = dict(has_header=name.endswith("header"), keep_nan=keep_nan)
        want = list(jparser.iter_text_file_chunks(files[name], 250, **kw))
        got = list(tparser.iter_text_file_chunks(files[name], 250, **kw))
        assert len(got) == len(want)
        for (gl, gx), (wl, wx) in zip(got, want):
            np.testing.assert_array_equal(gl, wl)
            np.testing.assert_array_equal(gx, wx)


def test_short_rows_and_blank_lines_read_as_pandas(tmp_path):
    path = tmp_path / "ragged.csv"
    path.write_text("a,b,c\n1,2,3\n7,8\n\n5,6,NA\n  \n9,,9\n")
    want = jparser.parse_text_file(str(path), has_header=True)
    got = tparser.parse_text_file(str(path), has_header=True)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_seventeen_digit_values_parse_as_python_float(tmp_path):
    """Correctly rounded parsing: at 17 significant digits pandas' float
    converter differs from float() in the last bit on about half the
    values (ROADMAP queue 3); the port's parse equals float() on all."""
    rng = np.random.RandomState(17)
    vals = np.concatenate([rng.randn(300, 5),
                           rng.randn(300, 5) * 10.0 ** rng.randint(
                               -8, 9, (300, 5))])
    lines = ["\t".join("%.17g" % v for v in row) for row in vals]
    path = tmp_path / "digits17.tsv"
    path.write_text("\n".join(lines) + "\n")
    label, feats, _, _, _ = tparser.parse_text_file(str(path))
    want = np.asarray([[float(tok) for tok in line.split("\t")]
                       for line in lines])
    np.testing.assert_array_equal(feats, want[:, 1:])
    np.testing.assert_array_equal(label, want[:, 0].astype(np.float32))


# ---------------------------------------------------------- column selection

@pytest.mark.parametrize("params", [
    {},
    {"label_column": "name:y", "weight_column": "name:wt",
     "group_column": "name:qid", "categorical_column": "name:cat",
     "ignore_column": "name:e"},
    {"weight_column": "6", "group_column": "7", "categorical_column": "2",
     "ignore_column": "4,5"},
    {"label_column": "3", "weight_column": "name:wt"},
], ids=["defaults", "by_name", "by_index", "label_elsewhere"])
def test_column_selectors_match_jax(files, params):
    j, t = _load_both(files["tsv_header"], dict(params, has_header=True))
    _same_core(j, t)


def test_side_files_match_jax(files, tmp_path):
    y, x = _table(seed=4, n=300)
    path = str(tmp_path / "side.csv")
    _write_text(path, y, x, ",", False)
    rng = np.random.RandomState(4)
    np.savetxt(path + ".weight", rng.rand(300) + 0.1, fmt="%.6g")
    np.savetxt(path + ".query", np.full(30, 10), fmt="%d")
    np.savetxt(path + ".init", rng.randn(300) * 0.1, fmt="%.9g")
    j, t = _load_both(path, {})
    assert t.metadata.weights is not None
    assert t.metadata.query_boundaries is not None
    assert t.metadata.init_score is not None
    _same_core(j, t)


@pytest.mark.parametrize("budget", [2, 3])
def test_max_bad_rows_quarantine_matches_jax(tmp_path, capfd, budget,
                                             warnings_shown):
    lines = ["a,b,c", "1,2,3", "4,x,6", "7,8", "1,2,3,4", "", "5,6,NA",
             "9,9,9", "1,zz,2", "0,1,2"]
    path = tmp_path / "bad.csv"
    path.write_text("\n".join(lines) + "\n")
    outs = []
    for mod in (jparser, tparser):
        try:
            outs.append(mod.parse_text_file(str(path), has_header=True,
                                            max_bad_rows=budget))
        except Exception as e:  # LightGBMError of either package
            outs.append(str(e))
    logged = capfd.readouterr()
    if budget < 3:
        assert isinstance(outs[0], str) and outs[1] == outs[0]
        assert "3 malformed rows" in outs[1]
        return
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    counts = re.findall(r"quarantined (\d+) malformed row\(s\)[^\n]*"
                        r"first offender: ([^\n]*)",
                        logged.out + logged.err)
    assert len(counts) == 2 and counts[0] == counts[1]
    assert counts[0][0] == "3"


def test_strict_parse_raises(tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text("1,2,3\n4,x,6\n")
    with pytest.raises(ValueError):
        tparser.parse_text_file(str(path))


# ---------------------------------------------------------------- streaming

@pytest.mark.parametrize("params", [
    {"has_header": True, "weight_column": "6", "group_column": "7"},
    {"has_header": True, "categorical_column": "2",
     "bin_construct_sample_cnt": 150},
], ids=["weight_group", "categorical_sampled"])
def test_two_round_equals_in_memory_and_jax(files, params):
    j, t = _load_both(files["tsv_header"],
                      dict(params, use_two_round_loading=True))
    _same_core(j, t)
    _, mem = _load_both(files["tsv_header"], params)
    _same_core(mem, t)


def test_wide_libsvm_streams_sparse_as_jax(tmp_path):
    """Feature ids past 1024 auto-route to the O(nnz) streamer; with
    bundling off (is_enable_sparse=false) both packages store the
    unbundled matrix, and with it on (the default) the same bundle plan
    and slot matrix; the aligned valid file streams too."""
    rng = np.random.RandomState(6)
    n, width = 300, 1100
    path, valid = str(tmp_path / "wide.svm"), str(tmp_path / "wide_v.svm")
    for p, rows in ((path, n), (valid, 80)):
        with open(p, "w") as f:
            for i in range(rows):
                cols = np.sort(rng.choice(width, 12, replace=False))
                cols[-1] = width - 1 if i % 3 == 0 else cols[-1]
                toks = [str(i % 2)] + [f"{c}:{rng.randn():.9g}"
                                       for c in np.unique(cols)]
                f.write(" ".join(toks) + "\n")
    params = {"is_enable_sparse": False, "bin_construct_sample_cnt": 200}
    j, t = _load_both(path, params)
    _same_core(j, t)
    jc, tc = _cfg(params)
    _same_core(JLoader(jc).load_from_file_align_with_other_dataset(valid, j),
               TLoader(tc).load_from_file_align_with_other_dataset(valid, t))
    j, t = _load_both(path, {"bin_construct_sample_cnt": 200})
    assert j.bundle_plan is not None
    _same_core(j, t)
    jc, tc = _cfg({})
    _same_core(JLoader(jc).load_from_file_align_with_other_dataset(valid, j),
               TLoader(tc).load_from_file_align_with_other_dataset(valid, t))


# ------------------------------------------------------------------ aligned

@pytest.mark.parametrize("train,valid,params", [
    ("tsv_header", "valid_tsv", {"has_header": True, "weight_column": "6"}),
    ("libsvm", "valid_svm", {}),
], ids=["tsv", "libsvm"])
def test_aligned_valid_files_match_jax(files, train, valid, params):
    j, t = _load_both(files[train], params)
    jc, tc = _cfg(params)
    jv = JLoader(jc).load_from_file_align_with_other_dataset(files[valid], j)
    tv = TLoader(tc).load_from_file_align_with_other_dataset(files[valid], t)
    _same_core(jv, tv)
    assert t.check_align(tv)


# ------------------------------------------------------------- binary cache

def test_binary_cache_crosses_packages(files, tmp_path):
    j, t = _load_both(files["tsv_header"],
                      {"has_header": True, "weight_column": "6",
                       "group_column": "7", "categorical_column": "2"})
    t.save_binary(str(tmp_path / "port.bin"))
    j.save_binary(str(tmp_path / "jax.bin"))
    _same_core(t, JCore.load_binary(str(tmp_path / "port.bin")))
    _same_core(j, TCore.load_binary(str(tmp_path / "jax.bin")))
    # Dataset.save_binary writes a data file's <file>.bin sibling, which
    # both loaders then read in place of the text
    path = str(tmp_path / "copy.tsv")
    with open(files["tsv_header"]) as src, open(path, "w") as dst:
        dst.write(src.read())
    params = {"has_header": True, "weight_column": "6", "group_column": "7",
              "categorical_column": "2", "verbose": -1}
    ds = lgt.Dataset(path, params=params)
    ds.save_binary(path + ".bin")
    jc, tc = _cfg({"has_header": True})
    _same_core(ds._core, JLoader(jc).load_from_file(path))
    _same_core(ds._core, TLoader(tc).load_from_file(path))
    _same_core(ds._core, TLoader(tc).load_from_file(path + ".bin"))


@pytest.mark.parametrize("damage", ["truncate", "flip", "foreign", "text"])
def test_rotten_cache_same_diagnosis(files, tmp_path, damage):
    _, t = _load_both(files["csv"], {})
    path = str(tmp_path / "cache.bin")
    t.save_binary(path)
    raw = bytearray(open(path, "rb").read())
    if damage == "truncate":
        raw = raw[:len(raw) // 2]
    elif damage == "flip":
        raw[len(raw) // 2] ^= 0xFF
    elif damage == "foreign":
        with open(path, "wb") as f:
            np.savez(f, magic=np.asarray("someone_else_v9"))
        raw = bytearray(open(path, "rb").read())
    else:
        raw = bytearray(b"1,2,3\n4,5,6\n")
    open(path, "wb").write(bytes(raw))
    errs = []
    for cls, err in ((JCore, JBinaryError), (TCore, TBinaryError)):
        with pytest.raises(err) as e:
            cls.load_binary(path)
        errs.append((str(e.value), e.value.claimed))
    assert errs[1] == errs[0]
    if damage != "text":
        # the data file itself is a broken cache: fatal, not a text parse
        with pytest.raises(LightGBMError):
            TLoader(TConfig.from_params({"verbose": -1})).load_from_file(path)


def test_rotten_sibling_cache_falls_back_to_text(files, tmp_path, capfd,
                                                 warnings_shown):
    path = str(tmp_path / "data.csv")
    with open(files["csv"]) as src, open(path, "w") as dst:
        dst.write(src.read())
    open(path + ".bin", "wb").write(b"PK\x03\x04 rotten")
    jc, tc = JConfig.from_params({"verbose": 0}), TConfig.from_params(
        {"verbose": 0})
    j, t = JLoader(jc).load_from_file(path), TLoader(tc).load_from_file(path)
    _same_core(j, t)
    logged = capfd.readouterr()
    assert "ignoring unusable binary cache" in logged.out + logged.err


# -------------------------------------------------------------- public API

def test_dataset_from_files_and_sparse_matrices(files):
    params = {"has_header": True, "verbose": -1}
    jd = lgj.Dataset(files["tsv_header"], params=params).construct()
    td = lgt.Dataset(files["tsv_header"], params=params).construct()
    _same_core(jd._core, td._core)
    jv = lgj.Dataset(files["valid_tsv"], reference=jd,
                     params=params).construct()
    tv = lgt.Dataset(files["valid_tsv"], reference=td,
                     params=params).construct()
    _same_core(jv._core, tv._core)
    # a matrix reference for a file, and a scipy sparse matrix (binned
    # through CSC columns, never densified)
    y, x = _table(seed=8, n=400)
    x[np.abs(x) < 0.8] = 0.0
    tm = lgt.Dataset(x.astype(np.float32), y)
    _same_core(lgj.Dataset(sp.csr_matrix(x), y).construct()._core,
               lgt.Dataset(sp.csr_matrix(x), y).construct()._core)
    _same_core(lgj.Dataset(x.astype(np.float32), y).construct()._core,
               tm.construct()._core)


def test_train_and_predict_from_files_match_jax(files, tmp_path):
    params = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 20,
              "verbose": -1, "partitioned_build": "false",
              "hist_compaction": "false", "device_row_chunk": 4096,
              "has_header": True, "weight_column": "6"}
    jb = lgj.train(params, lgj.Dataset(files["tsv_header"], params=params), 3)
    tb = lgt.train(params, lgt.Dataset(files["tsv_header"], params=params), 3,
                   device=CPU)
    want = jb.predict(files["valid_tsv"], data_has_header=True)
    got = tb.predict(files["valid_tsv"], data_has_header=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # a cache reload trains the same model, byte for byte
    cache = str(tmp_path / "train.bin")
    lgt.Dataset(files["tsv_header"], params=params).save_binary(cache)
    again = lgt.train(params, lgt.Dataset(cache, params=params), 3,
                      device=CPU)
    assert again.model_to_string() == tb.model_to_string()
    # the JAX package's predictions of the port's model file, bit for bit
    model = str(tmp_path / "port_model.txt")
    tb.save_model(model)
    np.testing.assert_array_equal(
        lgj.Booster(model_file=model).predict(files["valid_tsv"],
                                              data_has_header=True),
        lgt.Booster(model_file=model, device=CPU).predict(
            files["valid_tsv"], data_has_header=True))


def test_seventeen_digit_file_against_jax_records_the_divergence(tmp_path):
    """The JAX package's parse of a 17-digit file (pandas' converter)
    differs from the correctly rounded one in the last bit of about half
    the values; the measured effect on a model (ROADMAP queue 3): bins
    agree but for the values next to a moved bound, the trees split on
    the same features and bins, and thresholds move in the last digits.
    The counts below are this seed's."""
    rng = np.random.RandomState(171)
    n = 2000
    x = rng.randn(n, 6)
    y = (x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.randn(n) > 0).astype(int)
    path = str(tmp_path / "digits17.csv")
    with open(path, "w") as f:
        for i in range(n):
            f.write(",".join([str(y[i])] + ["%.17g" % v for v in x[i]])
                    + "\n")
    jl, jx, _, _, _ = jparser.parse_text_file(path)
    tl, tx, _, _, _ = tparser.parse_text_file(path)
    np.testing.assert_array_equal(tx, x)             # correctly rounded
    differ = int((jx != tx).sum())
    assert 0.3 < differ / tx.size < 0.7, differ      # about half at 17 digits
    assert np.abs(jx - tx).max() <= 2 * np.spacing(np.abs(tx)).max()
    params = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 20,
              "verbose": -1, "partitioned_build": "false",
              "hist_compaction": "false", "device_row_chunk": 4096}
    j, t = _load_both(path, params)
    bins_moved = int((j.bins != t.bins).sum())
    bounds_moved = sum(int((mj.bin_upper_bound != mt.bin_upper_bound).sum())
                       for mj, mt in zip(j.bin_mappers, t.bin_mappers))
    assert bins_moved <= 0.001 * t.bins.size
    jb = lgj.train(params, lgj.Dataset(path, params=params), 3)
    tb = lgt.train(params, lgt.Dataset(path, params=params), 3, device=CPU)
    jt = [m for m in jb.gbdt.models]
    tt = [m for m in tb.gbdt.models]
    thr_moved = 0
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(b.split_feature_real,
                                      a.split_feature_real)
        np.testing.assert_array_equal(b.threshold_in_bin, a.threshold_in_bin)
        np.testing.assert_allclose(b.threshold, a.threshold, rtol=1e-15,
                                   atol=0)
        thr_moved += int((b.threshold != a.threshold).sum())
    print(f"17-digit divergence: {differ} of {tx.size} values differ, "
          f"{bounds_moved} bin bounds and {bins_moved} bins moved, "
          f"{thr_moved} of {sum(len(m.threshold) for m in tt)} thresholds "
          "moved in 3 trees")
