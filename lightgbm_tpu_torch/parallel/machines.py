"""Machine lists, rank discovery and the ownership rules of the mesh
(port of lightgbm_tpu/parallel/machines.py: _split_host_port :17,
parse_machine_list :37, format_machine_list :74, partition_features
:84, partition_blocks :102, check_block_tiling :124, _local_addresses
:146, find_local_rank :156).

Reference: src/network/linkers_socket.cpp:20-86. Torch-free, so a
launcher can read and rewrite machine lists without touching the
device; parallel/distributed.py brings the process group up from them.
"""

import socket

from ..utils.log import Log


def _split_host_port(token, lineno):
    """One `host:port` token -> (host, port_str), IPv6-safe: bracketed
    `[addr]:port` is the canonical v6 form; a bare single-colon token is
    `host:port`; several colons without brackets is an IPv6 address with
    no parseable port, a hard error."""
    if token.startswith("["):
        host, bracket, port = token.partition("]")
        if not bracket or not port.startswith(":") or not port[1:]:
            Log.fatal("Machine list file parse error at line %d: %r "
                      "(bracketed IPv6 must be '[addr]:port')",
                      lineno, token)
        return host[1:], port[1:]
    if token.count(":") == 1:
        host, _, port = token.partition(":")
        return host, port
    Log.fatal("Machine list file parse error at line %d: %r (IPv6 "
              "addresses need '[addr]:port' or 'addr port')",
              lineno, token)


def parse_machine_list(path):
    """`ip port` (or `ip:port`) lines -> [(ip, port)]
    (linkers_socket.cpp:36-56). `#` starts a comment; IPv6 addresses use
    `[addr]:port` or `addr port`. A repeated host:port pair is a hard
    error: two ranks cannot share one port."""
    machines = []
    seen = {}
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) >= 2:
                host, port = parts[0], parts[1]
            else:
                host, port = _split_host_port(parts[0], lineno)
            if host.startswith("[") and host.endswith("]"):
                host = host[1:-1]
            try:
                port = int(port)
            except ValueError:
                Log.fatal("Machine list file parse error at line %d: "
                          "port %r is not an integer", lineno, port)
            if (host, port) in seen:
                Log.fatal("Machine list file line %d duplicates %s:%d "
                          "(first at line %d): every rank needs its own "
                          "host:port", lineno, host, port,
                          seen[(host, port)])
            seen[(host, port)] = lineno
            machines.append((host, port))
    return machines


def format_machine_list(machines):
    """[(host, port)] -> machine-list file text (IPv6 hosts bracketed, so
    the round trip through parse_machine_list is exact)."""
    lines = []
    for host, port in machines:
        lines.append(f"[{host}]:{port}" if ":" in host else f"{host} {port}")
    return "\n".join(lines) + "\n"


def partition_features(num_features, num_shards, shard):
    """Contiguous owned feature block of one shard under the mesh
    layer's reduce-scatter ownership rule (parallel/mesh.py): features
    are padded to a multiple of `num_shards` and shard r owns
    [r*f_loc, (r+1)*f_loc). Returns (lo, hi) in PADDED feature space
    (hi may exceed num_features for trailing shards — those indices are
    pad features that never win a split)."""
    num_shards = max(int(num_shards), 1)
    f_pad = -(-int(num_features) // num_shards) * num_shards
    f_loc = f_pad // num_shards
    lo = int(shard) * f_loc
    return lo, lo + f_loc


def partition_blocks(num_blocks, num_shards, shard):
    """Contiguous owned BLOCK range of one rank over a shared block
    store: rank r owns [r*base + min(r, rem), ...) where base =
    num_blocks // num_shards and the first `rem = num_blocks %
    num_shards` ranks carry one extra block. Blocks are real on-disk
    data units, so the ranges tile [0, num_blocks) exactly and every
    block has exactly one owner."""
    num_shards = max(int(num_shards), 1)
    num_blocks = int(num_blocks)
    shard = int(shard)
    base, rem = divmod(num_blocks, num_shards)
    lo = shard * base + min(shard, rem)
    hi = lo + base + (1 if shard < rem else 0)
    return lo, hi


def check_block_tiling(ranges, num_blocks):
    """Validate that per-rank (lo, hi) block ranges tile [0, num_blocks)
    exactly, in rank order, with no gap or overlap. A violation means a
    rank derived its range from a different world size than its peers;
    training on it would double-count or drop blocks, so it raises."""
    expect = 0
    for rank, (lo, hi) in enumerate(ranges):
        if int(lo) != expect or int(hi) < int(lo):
            raise ValueError(
                f"stale block-ownership lease: rank {rank} claims blocks "
                f"[{lo}, {hi}) but the previous ranks end at {expect} — "
                "ranks disagree on the world size; refusing to train")
        expect = int(hi)
    if expect != int(num_blocks):
        raise ValueError(
            f"stale block-ownership lease: ranks cover {expect} of "
            f"{num_blocks} blocks — ranks disagree on the world size; "
            "refusing to train")


def _local_addresses():
    names = {"localhost", "127.0.0.1", socket.gethostname()}
    try:
        host, aliases, ips = socket.gethostbyname_ex(socket.gethostname())
        names.update([host] + aliases + ips)
    except OSError:
        pass
    return names


def find_local_rank(machines):
    """linkers_socket.cpp:58-86: my rank is the first machine-list entry
    matching a local address."""
    local = _local_addresses()
    for i, (ip, _) in enumerate(machines):
        if ip in local:
            return i
    Log.fatal("Machine list file doesn't contain the local machine")
