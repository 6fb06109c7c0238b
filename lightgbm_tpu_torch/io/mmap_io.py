"""Mapped reads of the binary dataset cache (port of
lightgbm_tpu/data/mmap_io.py memmap_npz_member).

The binary dataset cache is an npz archive whose members np.savez
stores UNCOMPRESSED (ZIP_STORED), so a member's bytes sit contiguous
inside the zip and `memmap_npz_member` maps them in place: a warm cache
load does not materialize a second copy of the bin matrix on the way in
(io/dataset.py load_binary). `crc32_file` is the out-of-core block
store's digest (data/block_store.py).
"""

import struct
import zipfile
import zlib

import numpy as np

_LOCAL_HEADER_FMT = "<4s5H3I2H"
_LOCAL_HEADER_SIZE = struct.calcsize(_LOCAL_HEADER_FMT)  # 30
_LOCAL_MAGIC = b"PK\x03\x04"


def memmap_npz_member(path, name):
    """Read-only np.memmap over one .npy member of an npz archive, or
    None when the member is compressed / absent / not a plain mappable
    array (callers fall back to the np.load full-read path). `name` is
    the archive member name INCLUDING the .npy suffix."""
    try:
        with zipfile.ZipFile(path) as zf:
            try:
                info = zf.getinfo(name)
            except KeyError:
                return None
            if info.compress_type != zipfile.ZIP_STORED:
                return None  # deflated member: no contiguous bytes to map
            header_offset = info.header_offset
            member_size = info.file_size
            member_crc = info.CRC
        with open(path, "rb") as f:
            f.seek(header_offset)
            header = f.read(_LOCAL_HEADER_SIZE)
            if (len(header) != _LOCAL_HEADER_SIZE
                    or header[:4] != _LOCAL_MAGIC):
                return None
            fields = struct.unpack(_LOCAL_HEADER_FMT, header)
            name_len, extra_len = fields[9], fields[10]
            data_start = (header_offset + _LOCAL_HEADER_SIZE
                          + name_len + extra_len)
            f.seek(data_start)
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = \
                    np.lib.format.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, fortran, dtype = \
                    np.lib.format.read_array_header_2_0(f)
            else:
                return None
            if dtype.hasobject:
                return None
            data_offset = f.tell()
            # mapping bypasses zipfile's decompress-time CRC — the only
            # integrity check the archive has — so verify the member's
            # bytes (npy header + data) here, streamed through the page
            # cache (no second resident copy). A mismatch falls back to
            # the copying path, which surfaces the same BadZipFile the
            # pre-mapped-IO loader raised on a rotten cache.
            f.seek(data_start)
            crc, left = 0, member_size
            while left > 0:
                chunk = f.read(min(left, 1 << 22))
                if not chunk:
                    return None
                crc = zlib.crc32(chunk, crc)
                left -= len(chunk)
            if crc & 0xFFFFFFFF != member_crc:
                return None
        return np.memmap(path, dtype=dtype, mode="r", offset=data_offset,
                         shape=shape, order="F" if fortran else "C")
    except (OSError, ValueError, zipfile.BadZipFile):
        return None


def crc32_file(path, chunk_bytes=1 << 22):
    """zlib.crc32 of a whole file, streamed (block-digest verification;
    data/block_store.py)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF
