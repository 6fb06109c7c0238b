"""`python -m lightgbm_tpu_torch.fleet` — the registry admin CLI (the
port's copy of lightgbm_tpu/fleet/__main__.py's registry commands):

    python -m lightgbm_tpu_torch.fleet list     --registry DIR
    python -m lightgbm_tpu_torch.fleet publish  --registry DIR model.txt [--promote]
    python -m lightgbm_tpu_torch.fleet promote  --registry DIR --version N [--force]
    python -m lightgbm_tpu_torch.fleet rollback --registry DIR
    python -m lightgbm_tpu_torch.fleet verify   --registry DIR [--version N]

A server started with `python -m lightgbm_tpu_torch.serve --registry
DIR --follow` hot-swaps to a promotion (or rollback) on its next poll.
`route` (the front-door router) and `watch` (the drift -> retrain ->
promote loop) are not ported yet and exit 2.
"""

import argparse
import json
import sys

from .registry import ModelRegistry, RegistryError

NOT_PORTED = ("fleet {cmd}: not ported to lightgbm_tpu_torch yet (ROADMAP "
              "queue 1 item 7); use the registry commands")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.fleet",
        description="Model registry administration")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--registry", required=True,
                       help="registry directory")
        return p

    common(sub.add_parser("list", help="registry summary"))
    p = common(sub.add_parser("publish", help="publish a model file"))
    p.add_argument("model")
    p.add_argument("--profile", default=None,
                   help="profile sidecar (default: <model>.profile.json "
                        "when present)")
    p.add_argument("--promote", action="store_true",
                   help="promote the new version immediately")
    p = common(sub.add_parser("promote", help="move CURRENT"))
    p.add_argument("--version", type=int, required=True)
    p.add_argument("--force", action="store_true",
                   help="promote even a quarantined version")
    common(sub.add_parser("rollback",
                          help="restore the prior live version"))
    p = common(sub.add_parser("verify", help="re-checksum versions"))
    p.add_argument("--version", type=int, default=None)
    for cmd in ("route", "watch"):
        sub.add_parser(cmd, help="not ported yet")
    args, extra = ap.parse_known_args(argv)

    if args.cmd in ("route", "watch"):
        print(NOT_PORTED.format(cmd=args.cmd), file=sys.stderr)
        return 2
    if extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    registry = ModelRegistry(args.registry)
    try:
        if args.cmd == "list":
            print(json.dumps(registry.describe(), indent=1, default=str))
        elif args.cmd == "publish":
            version = registry.publish(args.model,
                                       profile_path=args.profile)
            print(f"published v{version}")
            if args.promote:
                registry.promote(version, reason="cli publish --promote")
                print(f"promoted v{version}")
        elif args.cmd == "promote":
            pointer = registry.promote(args.version, reason="cli",
                                       force=args.force)
            print(f"promoted v{pointer['version']} "
                  f"(generation {pointer['generation']})")
        elif args.cmd == "rollback":
            pointer = registry.rollback(reason="cli")
            print(f"rolled back to v{pointer['version']} "
                  f"(generation {pointer['generation']})")
        elif args.cmd == "verify":
            versions = ([args.version] if args.version is not None
                        else registry.versions())
            for v in versions:
                registry.verify(v)
                print(f"v{v}: OK")
            if not versions:
                print("no published versions")
    except RegistryError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
