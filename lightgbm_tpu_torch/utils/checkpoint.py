"""Crash-atomic file writes (the atomic IO of
lightgbm_tpu/utils/checkpoint.py :51-100).

A sibling tmp file, flush + fsync, `os.replace`, then a directory fsync:
a crash at any point leaves either the previous file or the complete
new one. The dataset profile (io/profile.py) saves through it. Training
snapshots and resume come with the port's fault-tolerance slice.
"""

import contextlib
import os


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
