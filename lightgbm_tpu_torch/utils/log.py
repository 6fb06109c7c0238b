"""Leveled logger (the port's copy of lightgbm_tpu/utils/log.py).

Reference: include/LightGBM/utils/log.h:14-98. Fatal raises.

`Log.structured` writes one machine-attributable record (the serving
access and slow-request logs, drift and skew warnings): with
`LIGHTGBM_TPU_LOG_JSON=1` in the environment every line is one JSON
object `{"ts", "level", ...}`, otherwise `event k=v ...` text. The flag
is read per line, as in the JAX package. `Log.set_rank` (called when the
process group comes up, parallel/distributed.py) prefixes every line
with `[rank N]` (a "rank" field in JSON mode), so the interleaved logs
of a process gang stay attributable.
"""

import datetime
import json
import os
import sys


def _json_mode():
    return os.environ.get("LIGHTGBM_TPU_LOG_JSON", "") not in ("", "0")


def _now():
    return datetime.datetime.now().isoformat(timespec="milliseconds")


class LightGBMError(Exception):
    """Error raised by the framework (reference: basic.py LightGBMError)."""


class Log:
    # levels: fatal=-1, warning=0, info=1, debug=2
    _level = 1
    _rank = None        # set by set_rank(); None = no rank prefix

    @classmethod
    def set_rank(cls, rank) -> None:
        """Prefix subsequent lines with `[rank N]`; None clears."""
        cls._rank = int(rank) if rank is not None else None

    @classmethod
    def reset_log_level(cls, level: int) -> None:
        cls._level = level

    @classmethod
    def set_level_from_verbosity(cls, verbosity: int) -> None:
        # reference: src/io/config.cpp:63-74
        if verbosity == 1:
            cls._level = 1
        elif verbosity == 0:
            cls._level = 0
        elif verbosity >= 2:
            cls._level = 2
        else:
            cls._level = -1

    @classmethod
    def debug(cls, fmt, *args):
        if cls._level >= 2:
            cls._write("Debug", fmt, args)

    @classmethod
    def info(cls, fmt, *args):
        if cls._level >= 1:
            cls._write("Info", fmt, args)

    @classmethod
    def warning(cls, fmt, *args):
        if cls._level >= 0:
            cls._write("Warning", fmt, args)

    @classmethod
    def fatal(cls, fmt, *args):
        msg = (fmt % args) if args else str(fmt)
        raise LightGBMError(msg)

    _LEVELS = {"Debug": 2, "Info": 1, "Warning": 0}

    @classmethod
    def structured(cls, level, event, **fields):
        """One record of `event` with `fields`; `level` is "Debug" /
        "Info" / "Warning" and gates like the plain methods."""
        if cls._level < cls._LEVELS.get(level, 1):
            return
        if _json_mode():
            rec = {"ts": _now(), "level": level, "event": str(event)}
            if cls._rank is not None:
                rec["rank"] = cls._rank
            rec.update(fields)
            sys.stdout.write(json.dumps(rec, default=str) + "\n")
            sys.stdout.flush()
            return
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        cls._write(level, "%s %s", (event, kv))

    @classmethod
    def _write(cls, level_str, fmt, args):
        msg = (fmt % args) if args else str(fmt)
        if _json_mode():
            rec = {"ts": _now(), "level": level_str, "msg": msg}
            if cls._rank is not None:
                rec["rank"] = cls._rank
            sys.stdout.write(json.dumps(rec) + "\n")
            sys.stdout.flush()
            return
        rank = "" if cls._rank is None else f"[rank {cls._rank}] "
        sys.stdout.write(f"[LightGBM-Torch] {rank}[{level_str}] {msg}\n")
        sys.stdout.flush()


def check(condition, msg="check failed"):
    """CHECK macro equivalent (log.h:86-98)."""
    if not condition:
        Log.fatal(msg)
