"""Text parsers: CSV / TSV / LibSVM with format auto-detection (port of
lightgbm_tpu/io/parser.py).

Reference: src/io/parser.cpp:72-144 (format sniffing from the first two
lines), src/io/parser.hpp:15-112 (per-line parsing; values with
|v| <= 1e-10 are treated as zero / not emitted).

numpy only. The JAX package reads CSV/TSV through pandas' C tokenizer;
here a block of lines goes through `np.loadtxt` (numpy's C reader), and
a block that reader refuses (NA tokens, empty fields, short or long
rows, unparsable cells) goes through a per-line pass with pandas'
rules: the NA tokens below and an empty field read as NaN, a row short
of the file's column count is padded with NaN, a longer row is an
error. Both read floats correctly rounded (`float()`), as pandas'
default converter does not on every input: at 15-17 significant digits
its value can differ in the last bit (ROADMAP queue 3). Features stay
float64, as the JAX parser keeps them.
"""

import itertools

import numpy as np

from ..utils.log import Log

ZERO_THRESHOLD = 1e-10
NA_VALUES = ["na", "NA", "nan", "NaN", "null"]
# pandas' default NA tokens (pandas._libs.parsers.STR_NA_VALUES), which
# read_csv keeps beside na_values=NA_VALUES; an empty field is one too
_NA_TOKENS = frozenset(NA_VALUES) | frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])
# lines a CSV/TSV block holds (the reader's unit; also the chunk of a
# whole-file parse)
_BLOCK_LINES = 1 << 16


def libsvm_pairs(tokens):
    """Parse `idx:val` tokens, skipping malformed ones (empty or
    non-numeric index, e.g. ranking-style `qid:3`, or an unparsable
    value); shared by the in-memory and streaming loaders so both paths
    treat the same line identically."""
    out = []
    for tok in tokens:
        c = tok.find(":")
        if c <= 0:
            continue
        try:
            idx, val = int(tok[:c]), float(tok[c + 1:])
        except ValueError:
            continue  # skip, matching the documented rule
        if idx < 0:
            continue  # a negative index would write the label column
        out.append((idx, val))
    return out


def _first_lines(path, n=2):
    lines = []
    with open(path, "r") as f:
        for line in f:
            line = line.rstrip("\r\n")
            if line:
                lines.append(line)
            if len(lines) >= n:
                break
    return lines


def detect_format(path) -> str:
    """Sniff CSV / TSV / LibSVM from the first two lines (parser.cpp:72-144)."""
    lines = _first_lines(path, 2)
    if not lines:
        Log.fatal("Data file %s is empty", str(path))
    probe = lines[-1]  # prefer the second line (first may be a header)
    num_colon = probe.count(":")
    num_tab = probe.count("\t")
    num_comma = probe.count(",")
    if num_colon > 0 and num_tab == 0 and num_comma == 0:
        return "libsvm"
    if num_tab > 0:
        return "tsv"
    if num_comma > 0:
        return "csv"
    if num_colon > 0:
        return "libsvm"
    return "tsv"  # single column fallback


def _separator(fmt):
    return "," if fmt == "csv" else "\t"


# --------------------------------------------------------------- LibSVM

def _densify_libsvm(labels, rows, max_idx):
    """(label f32, dense (N, max_idx+1) f64) from parsed LibSVM pairs,
    shared by the one-shot and streaming paths."""
    mat = np.zeros((len(rows), max_idx + 1), dtype=np.float64)
    for r, pairs in enumerate(rows):
        for i, v in pairs:
            mat[r, i] = v
    return np.asarray(labels, dtype=np.float32), mat


def iter_libsvm_rows(path, has_header):
    """(label, [(index, value), ...]) of every non-blank LibSVM line:
    the one line reader of the parser and the streamer."""
    with open(path, "r") as f:
        if has_header:
            next(f, None)
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            yield float(parts[0]), libsvm_pairs(parts[1:])


def _libsvm_chunks(path, has_header, chunk_rows):
    """(label f32, dense f64) chunks; a chunk's width is its largest
    feature index + 1."""
    it = iter_libsvm_rows(path, has_header)
    while True:
        block = list(itertools.islice(it, chunk_rows))
        if not block:
            return
        max_idx = max((i for _, pairs in block for i, _ in pairs), default=-1)
        yield _densify_libsvm([lab for lab, _ in block],
                              [pairs for _, pairs in block], max_idx)


def _parse_libsvm(path, has_header):
    """LibSVM: `label idx:val idx:val ...`; indices are used as-is (the
    reference's LibSVMParser does not shift them, parser.hpp:77-112)."""
    labels, rows, max_idx = [], [], -1
    for lab, pairs in iter_libsvm_rows(path, has_header):
        labels.append(lab)
        for i, _ in pairs:
            max_idx = max(max_idx, i)
        rows.append(pairs)
    label, mat = _densify_libsvm(labels, rows, max_idx)
    return label, mat, None


# -------------------------------------------------------------- CSV/TSV

def _cell(token):
    """One field as pandas reads it: an NA token or an empty field is
    NaN, anything else a float or ValueError."""
    s = token.strip()
    if s in _NA_TOKENS:
        return np.nan
    return float(s)


class TextTable:
    """A CSV/TSV file read as float64 blocks of rows, with the column
    count and header names of its first line (the parser's and the
    streamer's one reader). With `quarantine`, malformed rows (too many
    fields or an unparsable cell) are dropped and counted in `n_bad`
    instead of raising."""

    def __init__(self, path, fmt, has_header, quarantine=False):
        self.path = path
        self.sep = _separator(fmt)
        self.has_header = has_header
        self.quarantine = quarantine
        self.n_bad = 0
        with open(path, "r") as f:
            first = f.readline().rstrip("\r\n")
            if has_header:
                self.names = first.split(self.sep)
                self.ncols = len(self.names)
            else:
                self.names = None
                while first is not None and not first.strip():
                    line = f.readline()
                    first = line.rstrip("\r\n") if line else None
                self.ncols = len(first.split(self.sep)) if first else 0

    def blocks(self, block_lines=_BLOCK_LINES):
        """Yield (b, ncols) float64 blocks of `block_lines` lines each,
        NaN where pandas reads NaN; blank lines are skipped."""
        with open(self.path, "r") as f:
            lineno = 1
            if self.has_header:
                next(f, None)
                lineno = 2
            while True:
                lines = list(itertools.islice(f, block_lines))
                if not lines:
                    return
                yield self._parse_block(lines, lineno)
                lineno += len(lines)

    def _parse_block(self, lines, lineno):
        try:
            block = np.loadtxt(lines, delimiter=self.sep, comments=None,
                               ndmin=2, dtype=np.float64)
        except ValueError:
            return self._parse_lines(lines, lineno)
        if block.shape[1] != self.ncols and block.shape[0]:
            return self._parse_lines(lines, lineno)
        return block.reshape(-1, self.ncols)

    def _parse_lines(self, lines, lineno):
        """The per-line pass with pandas' rules."""
        rows = []
        for k, raw in enumerate(lines):
            line = raw.rstrip("\r\n")
            if not line.strip():
                continue  # pandas skips blank lines
            fields = line.split(self.sep)
            if len(fields) > self.ncols:
                if self.quarantine:
                    self.n_bad += 1
                    continue
                raise ValueError(
                    f"Error tokenizing data. Expected {self.ncols} fields "
                    f"in line {lineno + k}, saw {len(fields)}")
            try:
                row = [_cell(t) for t in fields]
            except ValueError as e:
                if self.quarantine:
                    self.n_bad += 1
                    continue
                raise ValueError(f"{self.path}: line {lineno + k}: {e}")
            row.extend([np.nan] * (self.ncols - len(row)))
            rows.append(row)
        return np.asarray(rows, dtype=np.float64).reshape(-1, self.ncols)


def _first_offender(path, sep, has_header, ncols):
    """Exact (line number, description) of the first malformed line, a
    raw-text second pass run only when the tolerant parse already found
    something to diagnose (the JAX parser's rule, word for word)."""
    with open(path, "r") as f:
        if has_header:
            next(f, None)
        for lineno, raw in enumerate(f, 2 if has_header else 1):
            line = raw.rstrip("\r\n")
            if not line:
                continue  # pandas skips blank lines
            fields = line.split(sep)
            if len(fields) != ncols:
                return (f"line {lineno}: wrong field count "
                        f"({len(fields)} != {ncols}): {line!r}")
            for col, token in enumerate(fields):
                token = token.strip()
                if token in _NA_TOKENS:
                    continue
                try:
                    float(token)
                except ValueError:
                    return (f"line {lineno}: column {col} value "
                            f"{token!r}")
    return "not re-locatable in a raw scan (quoting?)"


def _check_quarantine(table, max_bad_rows):
    """Fatal when the dropped rows exceed the budget; returns the first
    offender's description (None when nothing was dropped)."""
    if not table.n_bad:
        return None
    first = _first_offender(table.path, table.sep, table.has_header,
                            table.ncols)
    if table.n_bad > max_bad_rows:
        Log.fatal("%d malformed rows in %s exceed max_bad_rows=%d; "
                  "first offender: %s", table.n_bad, str(table.path),
                  max_bad_rows, first)
    return first


def _resolve_label_idx(label_column, names, path):
    """Reference label-column resolution (`DatasetLoader::SetHeader`):
    default column 0, `name:xxx` selects by header name, plain integers
    are file-column indices."""
    if label_column == "":
        return 0
    if str(label_column).startswith("name:"):
        want = str(label_column)[5:]
        if names is None or want not in names:
            Log.fatal("Could not find label column %s in data file", want)
        return names.index(want)
    return int(label_column)


def iter_text_file_chunks(path, chunk_rows, has_header=False,
                          label_column="", max_bad_rows=0,
                          keep_nan=False):
    """Stream a data file as (label, features) float chunks of at most
    `chunk_rows` rows: the bounded-memory twin of parse_text_file (same
    format sniffing, NA handling, label-column resolution and
    quarantine rule), used by the file predict path.

    `keep_nan=True` keeps NA cells as NaN instead of the training
    ingestion's NaN -> 0.0, so file prediction routes missing values as
    the serving endpoint does. CSV/TSV chunks all share the file's
    column count; a LibSVM chunk's width is the largest feature index
    seen in that chunk + 1 (callers align widths). The `max_bad_rows`
    budget is shared across the whole file."""
    fmt = detect_format(path)
    if fmt == "libsvm":
        yield from _libsvm_chunks(path, has_header, chunk_rows)
        return
    table = TextTable(path, fmt, has_header, quarantine=max_bad_rows > 0)
    label_idx = _resolve_label_idx(label_column, table.names, path)
    for data in table.blocks(chunk_rows):
        if table.n_bad > max_bad_rows:
            _check_quarantine(table, max_bad_rows)
        if not keep_nan:
            data = np.nan_to_num(data, nan=0.0)
        label = data[:, label_idx].astype(np.float32)
        yield label, np.delete(data, label_idx, axis=1)
    if table.n_bad:
        Log.warning("quarantined %d malformed row(s) in %s "
                    "(max_bad_rows=%d)", table.n_bad, str(path),
                    max_bad_rows)


def parse_text_file(path, has_header=False, label_column="",
                    max_bad_rows=0):
    """Parse a data file into
    (label, features (N, C-1) float64, header names, format, label_idx).

    label/weight/group column resolution follows the reference
    (`DatasetLoader::SetHeader`, dataset_loader.cpp:57-160): label
    defaults to column 0; `name:xxx` selects by header name; plain
    integers are file-column indices. Feature indices do NOT count the
    label column.

    max_bad_rows > 0 tolerates up to that many malformed CSV/TSV rows
    (dropped, with the count and the first offender in a warning); the
    default 0 keeps strict mode: the first malformed row aborts the
    load.
    """
    fmt = detect_format(path)
    if fmt == "libsvm":
        label, mat, names = _parse_libsvm(path, has_header)
        return label, mat, names, fmt, 0

    table = TextTable(path, fmt, has_header, quarantine=max_bad_rows > 0)
    blocks = list(table.blocks())
    data = np.concatenate(blocks) if blocks else np.zeros((0, table.ncols))
    first = _check_quarantine(table, max_bad_rows)
    if first is not None:
        Log.warning("quarantined %d malformed row(s) in %s "
                    "(max_bad_rows=%d); first offender: %s",
                    table.n_bad, str(path), max_bad_rows, first)
    names = table.names
    data = np.nan_to_num(data, nan=0.0)
    label_idx = _resolve_label_idx(label_column, names, path)
    label = data[:, label_idx].astype(np.float32)
    # keep float64: the reference parses and bins in double (parser.hpp),
    # and a float32 round trip perturbs bin boundaries in the last digit
    feats = np.delete(data, label_idx, axis=1)
    feat_names = None
    if names is not None:
        feat_names = [n for i, n in enumerate(names) if i != label_idx]
    return label, feats, feat_names, fmt, label_idx
