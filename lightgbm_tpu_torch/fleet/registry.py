"""Model registry: versioned, CRC-manifested on-disk model store (the
port's copy of lightgbm_tpu/fleet/registry.py; the same layout and
files, so either package reads the other's registry).

Layout (one directory, nothing else writes into it):

    registry/
      CURRENT                    # atomic JSON pointer: live version,
                                 # generation counter, promote history
      versions/
        v00000001/
          model.txt              # the text model format
          model.txt.profile.json # dataset-profile sidecar (optional)
          metadata.json          # train config, eval metrics, lineage
          MANIFEST.json          # crc32 + byte count per file

Version directories are IMMUTABLE after publish: `publish` stages
everything in a sibling tmp directory (each file fsynced), writes the
CRC manifest last, then `os.rename`s the whole directory into place —
the block store's crash-atomicity discipline (data/block_store.py), so
a kill at any instant leaves either no version or a complete, verified
one, never a torn one. Promotion only moves the CURRENT pointer
(atomic_write_text: tmp+fsync+rename), so `rollback` restores the
prior version BYTE-identically — the files never moved.

`quarantine` marks a rejected challenger without deleting it (the
evidence of a failed validation is operationally valuable); a
quarantined version cannot be promoted without `force=True`.

Every transition (promote / reject / rollback) is journaled through
the run journal (telemetry/journal.py) when one is attached, and the
trace exporter (telemetry/export.py) renders them as instant markers.

stdlib plus the checkpoint module's atomic-write helpers: importing it
touches no device.
"""

import json
import os
import shutil
import time

from ..io.mmap_io import crc32_file
from ..utils import faults
from ..utils.checkpoint import _fsync_dir, atomic_write_text
from ..utils.log import Log

REGISTRY_FORMAT_VERSION = 1
CURRENT_NAME = "CURRENT"
VERSIONS_DIR = "versions"
MANIFEST_NAME = "MANIFEST.json"
METADATA_NAME = "metadata.json"
MODEL_NAME = "model.txt"
QUARANTINE_NAME = "QUARANTINED"
# how many promote generations the CURRENT pointer remembers — the
# rollback depth (each entry is ~40 bytes; 50 is weeks of promotions)
HISTORY_DEPTH = 50


class RegistryError(Exception):
    """A registry operation failed validation (missing/corrupt version,
    illegal transition)."""


def _version_dirname(version):
    return f"v{int(version):08d}"


class ModelRegistry:
    """One registry directory (module docstring). Safe for concurrent
    READERS in other processes (a serving follower polling CURRENT
    while the pipeline promotes); writers are expected to be a single
    fleet supervisor — publishes allocate versions by directory scan,
    which two concurrent writers could race."""

    def __init__(self, directory, journal=None):
        self.directory = os.fspath(directory)
        self.versions_dir = os.path.join(self.directory, VERSIONS_DIR)
        self.journal = journal
        os.makedirs(self.versions_dir, exist_ok=True)

    # ------------------------------------------------------------ helpers
    def _journal(self, event, **fields):
        if self.journal is not None:
            self.journal.event(event, **fields)

    def version_dir(self, version):
        return os.path.join(self.versions_dir, _version_dirname(version))

    def model_path(self, version):
        return os.path.join(self.version_dir(version), MODEL_NAME)

    def profile_path(self, version):
        """The profile sidecar path, or None when the version was
        published without one."""
        p = os.path.join(self.version_dir(version),
                         MODEL_NAME + ".profile.json")
        return p if os.path.exists(p) else None

    def versions(self):
        """Sorted list of published version numbers (complete
        directories only — a crash-abandoned tmp stage is invisible)."""
        out = []
        try:
            names = os.listdir(self.versions_dir)
        except OSError:
            return out
        for name in names:
            if name.startswith("v") and name[1:].isdigit() \
                    and os.path.exists(os.path.join(
                        self.versions_dir, name, MANIFEST_NAME)):
                out.append(int(name[1:]))
        out.sort()
        return out

    def metadata(self, version):
        path = os.path.join(self.version_dir(version), METADATA_NAME)
        try:
            with open(path, "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            raise RegistryError(f"unreadable metadata for v{version}: {e}")

    def is_quarantined(self, version):
        return os.path.exists(os.path.join(self.version_dir(version),
                                           QUARANTINE_NAME))

    # ------------------------------------------------------------ publish
    def publish(self, model_path, profile_path=None, metadata=None):
        """Stage model (+ optional profile sidecar) + metadata into the
        next version directory and land it atomically. Returns the new
        version number. The model file must exist; a missing profile
        next to it is allowed (drift monitoring is then off for this
        version). Publish does NOT promote — the new version is a
        candidate until `promote`."""
        model_path = os.fspath(model_path)
        if not os.path.exists(model_path):
            raise RegistryError(f"no model file at {model_path}")
        if profile_path is None:
            from ..io.profile import model_profile_path
            sidecar = model_profile_path(model_path)
            profile_path = sidecar if os.path.exists(sidecar) else None
        existing = self.versions()
        version = (existing[-1] + 1) if existing else 1
        final_dir = self.version_dir(version)
        tmp_dir = os.path.join(self.versions_dir,
                               f".tmp.{_version_dirname(version)}."
                               f"{os.getpid()}")
        try:
            os.makedirs(tmp_dir)
            files = {MODEL_NAME: model_path}
            if profile_path:
                files[MODEL_NAME + ".profile.json"] = os.fspath(
                    profile_path)
            manifest_files = {}
            for name, src in files.items():
                dst = os.path.join(tmp_dir, name)
                shutil.copyfile(src, dst)
                with open(dst, "rb") as f:
                    os.fsync(f.fileno())
                manifest_files[name] = {
                    "bytes": os.path.getsize(dst),
                    "crc32": int(crc32_file(dst)),
                }
            meta = dict(metadata or {})
            meta.setdefault("published_ts", time.time())
            meta_path = os.path.join(tmp_dir, METADATA_NAME)
            with open(meta_path, "w", encoding="utf-8") as f:
                json.dump(meta, f, indent=1, default=str)
                f.flush()
                os.fsync(f.fileno())
            manifest_files[METADATA_NAME] = {
                "bytes": os.path.getsize(meta_path),
                "crc32": int(crc32_file(meta_path)),
            }
            # the manifest is written LAST: its presence is what marks
            # the stage complete (versions() requires it)
            man_path = os.path.join(tmp_dir, MANIFEST_NAME)
            with open(man_path, "w", encoding="utf-8") as f:
                json.dump({"format_version": REGISTRY_FORMAT_VERSION,
                           "version": version,
                           "files": manifest_files}, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            # the staged dir's own dirents must be durable BEFORE the
            # rename: without this a power loss could surface the
            # renamed version with a file's directory entry missing
            _fsync_dir(tmp_dir)
            os.rename(tmp_dir, final_dir)
        except BaseException:
            shutil.rmtree(tmp_dir, ignore_errors=True)
            raise
        _fsync_dir(self.versions_dir)
        Log.info("registry: published v%d (%s%s)", version, model_path,
                 ", with profile" if profile_path else "")
        return version

    def verify(self, version):
        """Re-checksum every manifested file of a version; raises
        RegistryError on any mismatch (bit rot, truncation, tamper).
        Returns the parsed manifest."""
        if faults.consume("corrupt_registry_version"):
            # chaos: a torn publish — verify must fail exactly as if a
            # checksum mismatched, so followers refuse the swap and the
            # incumbent keeps serving
            raise RegistryError(
                f"v{version}: injected fault corrupt_registry_version")
        vdir = self.version_dir(version)
        man_path = os.path.join(vdir, MANIFEST_NAME)
        try:
            with open(man_path, "r", encoding="utf-8") as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise RegistryError(f"v{version} has no readable manifest: {e}")
        for name, rec in manifest.get("files", {}).items():
            path = os.path.join(vdir, name)
            if not os.path.exists(path):
                raise RegistryError(f"v{version} is missing {name}")
            size = os.path.getsize(path)
            if size != int(rec["bytes"]):
                raise RegistryError(
                    f"v{version}/{name}: {size} bytes, manifest says "
                    f"{rec['bytes']}")
            crc = int(crc32_file(path))
            if crc != int(rec["crc32"]):
                raise RegistryError(
                    f"v{version}/{name}: crc32 {crc:#010x} != manifest "
                    f"{int(rec['crc32']):#010x}")
        return manifest

    # ------------------------------------------------------------ pointer
    def current(self):
        """The CURRENT pointer dict ({version, generation, ts,
        history}) or None before the first promotion. A torn/corrupt
        pointer reads as None (the writer is atomic, so this only
        happens on foreign interference)."""
        path = os.path.join(self.directory, CURRENT_NAME)
        try:
            with open(path, "r", encoding="utf-8") as f:
                cur = json.load(f)
        except OSError:
            return None
        except ValueError:
            Log.warning("registry: unreadable CURRENT pointer at %s", path)
            return None
        return cur if isinstance(cur, dict) and "version" in cur else None

    def current_version(self):
        cur = self.current()
        return int(cur["version"]) if cur else None

    def _write_pointer(self, version, prev, reason, history=None):
        """Atomically write CURRENT. `history` defaults to the promote
        rule (append the previously live version); rollback passes its
        own popped history."""
        generation = (int(prev["generation"]) + 1) if prev else 1
        if history is None:
            history = list(prev.get("history", [])) if prev else []
            if prev:
                history.append(int(prev["version"]))
                history = history[-HISTORY_DEPTH:]
        pointer = {"version": int(version), "generation": generation,
                   "ts": time.time(), "reason": str(reason or ""),
                   "history": history}
        atomic_write_text(os.path.join(self.directory, CURRENT_NAME),
                          json.dumps(pointer, separators=(",", ":"))
                          + "\n")
        return pointer

    def promote(self, version, reason="", force=False, **journal_fields):
        """Verify a version's manifest and move the CURRENT pointer to
        it (atomic). Quarantined versions need `force=True`. Returns
        the new pointer dict and journals a `promote` record."""
        version = int(version)
        self.verify(version)
        if self.is_quarantined(version) and not force:
            raise RegistryError(
                f"v{version} is quarantined; promote(force=True) to "
                "override")
        prev = self.current()
        if prev and int(prev["version"]) == version:
            Log.info("registry: v%d already live", version)
            return prev
        pointer = self._write_pointer(version, prev, reason)
        self._journal("promote", version=version,
                      from_version=int(prev["version"]) if prev else None,
                      generation=pointer["generation"],
                      reason=str(reason or ""), **journal_fields)
        Log.structured("Info", "fleet_promote", version=version,
                       from_version=prev["version"] if prev else None,
                       generation=pointer["generation"])
        return pointer

    def quarantine(self, version, reason="", **journal_fields):
        """Mark a candidate as rejected (a failed validation). The
        files stay — evidence, not garbage. Journals a `reject`
        record. Quarantining the LIVE version is refused: roll back
        first."""
        version = int(version)
        if version not in self.versions():
            raise RegistryError(f"no published v{version} to quarantine")
        cur = self.current()
        if cur and int(cur["version"]) == version:
            raise RegistryError(
                f"v{version} is live; rollback before quarantining")
        marker = os.path.join(self.version_dir(version), QUARANTINE_NAME)
        atomic_write_text(marker, json.dumps(
            {"ts": time.time(), "reason": str(reason or "")}) + "\n")
        self._journal("reject", version=version,
                      reason=str(reason or ""), **journal_fields)
        Log.structured("Warning", "fleet_reject", version=version,
                       reason=str(reason or ""))

    def rollback(self, reason="", **journal_fields):
        """Move CURRENT back to the previously live version (pointer
        history). The restored version's files never moved, so the
        restore is byte-identical; the manifest is re-verified anyway.
        Returns the new pointer dict and journals a `rollback`
        record."""
        cur = self.current()
        if not cur:
            raise RegistryError("nothing is live; cannot roll back")
        history = list(cur.get("history", []))
        if not history:
            raise RegistryError("no prior version in pointer history")
        target = int(history[-1])
        self.verify(target)
        pointer = self._write_pointer(target, cur,
                                      reason or "rollback",
                                      history=history[:-1])
        self._journal("rollback", version=target,
                      from_version=int(cur["version"]),
                      generation=pointer["generation"],
                      reason=str(reason or ""), **journal_fields)
        Log.structured("Warning", "fleet_rollback", version=target,
                       from_version=int(cur["version"]))
        return pointer

    # ------------------------------------------------------------ summary
    def describe(self):
        """JSON-ready registry summary (the CLI's `list` view)."""
        cur = self.current()
        out = {"directory": self.directory,
               "current": cur, "versions": []}
        for v in self.versions():
            rec = {"version": v,
                   "live": bool(cur and int(cur["version"]) == v),
                   "quarantined": self.is_quarantined(v),
                   "has_profile": self.profile_path(v) is not None}
            try:
                meta = self.metadata(v)
                for key in ("published_ts", "metric", "metric_name",
                            "parent_version", "train_rows", "source"):
                    if key in meta:
                        rec[key] = meta[key]
            except RegistryError:
                rec["metadata_error"] = True
            out["versions"].append(rec)
        return out
