"""Atomic training checkpoints: serialize, rotate, validate, resume
(port of lightgbm_tpu/utils/checkpoint.py).

A checkpoint captures the full training state (models/gbdt.py
capture_training_state: trees, score arrays, host RNG streams, the
bin-space split encoding, early-stop bookkeeping), so
`engine.train(..., resume_from=...)` and the CLI's `snapshot_freq`
produce the model text an uninterrupted run would have produced, byte
for byte.

File format (version 1), the JAX package's byte for byte, so that a
snapshot either package writes decodes in the other:

    LGBMTPUCKPT1\\n
    digest=<sha256 hex of payload>\\n
    length=<payload byte count>\\n
    <payload: npz archive>

The npz payload holds a `meta_json` entry (scalars, strings, callback
state) plus one entry per numpy array (scores, RNG key vectors). Files
are `<prefix>.iterNNNNNNNN.ckpt`. Writes are crash-atomic: a tmp file in
the same directory -> flush -> fsync -> `os.replace` (plus a best-effort
directory fsync), so a kill at any instant leaves either the old file or
the new one. The loader verifies length and digest, and `load_latest`
falls back past corrupt or truncated checkpoints to the newest valid
one. Rotation keeps the newest `keep_last_k` files. The dataset profile
(io/profile.py) and the binary cache save through the same atomic
writes.
"""

import contextlib
import hashlib
import io
import json
import os
import re

import numpy as np

from . import faults
from .log import Log

MAGIC = b"LGBMTPUCKPT1"
_FILE_RE = re.compile(r"^(?P<prefix>.+)\.iter(?P<iter>\d{8})\.ckpt$")


class CheckpointError(Exception):
    """A checkpoint file failed validation (missing/truncated/corrupt)."""


# ------------------------------------------------------------ atomic IO

def _fsync_dir(path):
    """Best-effort fsync of a directory (persists the rename itself)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path, data):
    """Write `data` to `path` crash-atomically: sibling tmp file,
    flush + fsync, `os.replace`, directory fsync. A crash at any point
    leaves either the previous file or the complete new one."""
    with atomic_open(path) as f:
        f.write(data)


def atomic_write_text(path, text):
    atomic_write_bytes(path, text.encode("utf-8"))


@contextlib.contextmanager
def atomic_open(path, mode="wb"):
    """Streaming variant of `atomic_write_bytes`: yields a file handle
    writers can stream into (no in-memory copy of the payload); on
    clean exit the tmp file is fsynced and renamed over `path`, on any
    exception it is removed and the previous file survives."""
    path = os.fspath(path)
    directory = os.path.dirname(os.path.abspath(path))
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, mode) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(directory)


# ------------------------------------------------------- state <-> bytes

def _pack_state(state):
    """Training-state dict -> payload bytes. Arrays become npz entries;
    everything else rides in `meta_json` (floats may be +-inf: Python's
    json emits/accepts Infinity)."""
    arrays = {}
    meta = {}
    for key, value in state.items():
        if isinstance(value, np.ndarray):
            arrays[f"arr_{key}"] = value
        elif (isinstance(value, (list, tuple)) and value
              and all(isinstance(v, np.ndarray) for v in value)):
            meta[f"_arrlist_{key}"] = len(value)
            for i, v in enumerate(value):
                arrays[f"arrlist_{key}_{i}"] = v
        else:
            meta[key] = value
    buf = io.BytesIO()
    np.savez_compressed(buf, meta_json=np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8), **arrays)
    return buf.getvalue()


def _unpack_state(payload):
    try:
        z = np.load(io.BytesIO(payload), allow_pickle=False)
    except Exception as e:
        raise CheckpointError(f"payload is not a valid archive: {e}")
    if "meta_json" not in z:
        raise CheckpointError("payload missing meta_json")
    meta = json.loads(bytes(z["meta_json"].tobytes()).decode("utf-8"))
    state = {}
    for key, value in meta.items():
        if key.startswith("_arrlist_"):
            name = key[len("_arrlist_"):]
            state[name] = [z[f"arrlist_{name}_{i}"] for i in range(value)]
        else:
            state[key] = value
    for key in z.files:
        if key.startswith("arr_"):
            state[key[len("arr_"):]] = z[key]
    return state


def encode_checkpoint(state):
    """State dict -> full file bytes (header + digest + payload)."""
    payload = _pack_state(state)
    digest = hashlib.sha256(payload).hexdigest()
    header = MAGIC + b"\n" + f"digest={digest}\n".encode("ascii") \
        + f"length={len(payload)}\n".encode("ascii")
    return header + payload


def decode_checkpoint(blob):
    """Full file bytes -> state dict; raises CheckpointError on any
    validation failure (bad magic, short file, digest mismatch)."""
    head, sep, rest = blob.partition(b"\n")
    if head != MAGIC or not sep:
        raise CheckpointError("bad magic (not a lightgbm_tpu checkpoint)")
    dline, sep, rest = rest.partition(b"\n")
    if not sep or not dline.startswith(b"digest="):
        raise CheckpointError("missing digest header")
    lline, sep, payload = rest.partition(b"\n")
    if not sep or not lline.startswith(b"length="):
        raise CheckpointError("missing length header")
    try:
        length = int(lline[len(b"length="):])
    except ValueError:
        raise CheckpointError("unparsable length header")
    if len(payload) != length:
        raise CheckpointError(
            f"truncated payload: {len(payload)} bytes, expected {length}")
    digest = dline[len(b"digest="):].decode("ascii", "replace")
    actual = hashlib.sha256(payload).hexdigest()
    if actual != digest:
        raise CheckpointError(
            f"digest mismatch: header {digest[:12]}.., payload {actual[:12]}..")
    return _unpack_state(payload)


# ---------------------------------------------------------------- manager

class CheckpointManager:
    """Directory of rotated, digest-validated checkpoints.

    Files are `<prefix>.iter<NNNNNNNN>.ckpt`, newest = highest
    iteration. `save` is crash-atomic; `load_latest` returns the newest
    checkpoint that validates, skipping (with a warning) any corrupt or
    truncated ones, so a crash mid-save, a torn disk write or bit rot in
    the newest file costs at most one snapshot interval of work.
    """

    def __init__(self, directory, keep_last_k=3, prefix="snapshot"):
        self.directory = os.fspath(directory)
        self.keep_last_k = max(1, int(keep_last_k))
        self.prefix = prefix
        os.makedirs(self.directory, exist_ok=True)

    def path_for(self, iteration):
        return os.path.join(self.directory,
                            f"{self.prefix}.iter{int(iteration):08d}.ckpt")

    def checkpoints(self):
        """[(iteration, path)] sorted oldest -> newest."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            m = _FILE_RE.match(name)
            if m and m.group("prefix") == self.prefix:
                out.append((int(m.group("iter")),
                            os.path.join(self.directory, name)))
        out.sort()
        return out

    def save(self, state, iteration):
        """Serialize + atomically write one checkpoint, then rotate.
        Returns the file path."""
        state = dict(state)
        state["checkpoint_iteration"] = int(iteration)
        blob = encode_checkpoint(state)
        # fault injection: a torn write or bit rot that still lands
        # atomically (the loader's validation must catch it)
        blob = faults.mangle_checkpoint_blob(blob)
        path = self.path_for(iteration)
        # fault injection: a kill mid-write, before the rename (the
        # previous checkpoint must survive, the tmp debris be ignored)
        faults.crash_in_checkpoint_write_if_armed(
            f"{path}.tmp.{os.getpid()}", blob)
        atomic_write_bytes(path, blob)
        Log.debug("Checkpoint saved: %s (%d bytes)", path, len(blob))
        self._rotate()
        return path

    def _rotate(self):
        entries = self.checkpoints()
        for _, path in entries[:-self.keep_last_k]:
            try:
                os.unlink(path)
                Log.debug("Checkpoint rotated out: %s", path)
            except OSError as e:
                Log.warning("could not remove old checkpoint %s: %s",
                            path, e)

    def load(self, path):
        """Read + validate one checkpoint file. Raises CheckpointError."""
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError as e:
            raise CheckpointError(f"cannot read {path}: {e}")
        return decode_checkpoint(blob)

    def load_latest(self):
        """(state, path) of the newest VALID checkpoint, or (None, None).
        Invalid files are skipped with a warning, newest first."""
        for iteration, path in reversed(self.checkpoints()):
            try:
                state = self.load(path)
            except CheckpointError as e:
                Log.warning("skipping invalid checkpoint %s: %s", path, e)
                continue
            Log.info("Resuming from checkpoint %s (iteration %d)",
                     path, iteration)
            return state, path
        return None, None
