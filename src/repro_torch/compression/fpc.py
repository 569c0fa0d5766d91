"""Frequent Pattern Compression (FPC) [Alameldeen & Wood 2004], a numpy
copy of `repro.compression.fpc`.

Per 32-bit word, a 3-bit prefix selects one of 8 patterns; zero words are
run-length encoded (up to 8 per run).  This is the per-line codec CRAM uses
(hybridized with BDI in hybrid.py), matching §III-A of the paper.

  * fpc_size_bits / fpc_size_bytes — vectorized sizes on numpy arrays (the
    reference's also take `xp=jax.numpy`; the port's tensor path for sizes
    is the scan kernel, `kernels/compress_scan.py`);
  * fpc_pack / fpc_pack_batch / fpc_unpack — the exact bit-level round trip.

Pattern table (prefix: pattern -> payload bits):
  000 zero run (3-bit run length, 1..8 zeros)    -> 3
  001 4-bit sign-extended word                   -> 4
  010 8-bit sign-extended word                   -> 8
  011 16-bit sign-extended word                  -> 16
  100 halfword padded with a zero halfword       -> 16 (low half zero)
  101 two halfwords, each an 8-bit SE halfword   -> 16
  110 word of 4 repeated bytes                   -> 8
  111 uncompressed word                          -> 32
"""

from __future__ import annotations

import numpy as np

from .bits import BitReader, BitWriter, bytes_to_u32, u32_to_bytes

WORDS_PER_LINE = 16
PREFIX_BITS = 3
# worst case: every word raw (3 + 32 bits) -> ceil(16 * 35 / 8) bytes.
# Streaming decoders may slice their input to this bound per line.
MAX_LINE_BYTES = (WORDS_PER_LINE * (PREFIX_BITS + 32) + 7) // 8

P_ZRUN, P_SE4, P_SE8, P_SE16, P_PAD16, P_HALF_SE8, P_REPB, P_RAW = range(8)

_PAYLOAD_BITS = {
    P_ZRUN: 3,
    P_SE4: 4,
    P_SE8: 8,
    P_SE16: 16,
    P_PAD16: 16,
    P_HALF_SE8: 16,
    P_REPB: 8,
    P_RAW: 32,
}


def _classify_nonzero(w_i32):
    """Pattern id for each (nonzero) word; vectorized. w_i32: int array."""
    w = w_i32.astype(np.int64)
    se4 = (w >= -8) & (w < 8)
    se8 = (w >= -128) & (w < 128)
    se16 = (w >= -32768) & (w < 32768)
    u = w & 0xFFFFFFFF
    pad16 = (u & 0xFFFF) == 0
    lo = ((u & 0xFFFF) ^ 0x8000) - 0x8000  # sign-extend low half
    hi = (((u >> 16) & 0xFFFF) ^ 0x8000) - 0x8000
    half_se8 = (lo >= -128) & (lo < 128) & (hi >= -128) & (hi < 128)
    b0 = u & 0xFF
    repb = (b0 == ((u >> 8) & 0xFF)) & (b0 == ((u >> 16) & 0xFF)) & (
        b0 == ((u >> 24) & 0xFF)
    )
    # priority: smallest encoding wins, in a fixed order so pack and size
    # agree: se4 < se8 < repb < se16 < pad16 < half_se8 < raw.
    pat = np.full(w.shape, P_RAW, dtype=np.int32)
    pat = np.where(half_se8, P_HALF_SE8, pat)
    pat = np.where(pad16, P_PAD16, pat)
    pat = np.where(se16, P_SE16, pat)
    pat = np.where(repb, P_REPB, pat)
    pat = np.where(se8, P_SE8, pat)
    pat = np.where(se4, P_SE4, pat)
    return pat


_PAYLOAD_BITS_TABLE = np.asarray([_PAYLOAD_BITS[p] for p in range(8)],
                                 dtype=np.int32)


def fpc_size_bits(lines_u32):
    """Compressed size in BITS for each line.

    lines_u32: (..., 16) uint32/int32 array of words.
    Returns (...,) int32 sizes (payload + prefixes, zero-run encoded).
    """
    w = np.asarray(lines_u32).astype(np.int64)
    w_i32 = ((w & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000  # as signed int32
    zero = w_i32 == 0
    pat = _classify_nonzero(w_i32)
    nz_bits = np.where(zero, 0, PREFIX_BITS + _PAYLOAD_BITS_TABLE[pat])
    total_nz = nz_bits.sum(axis=-1)

    # zero runs: each run of length L contributes ceil(L/8)*(3+3) bits.
    prev = np.concatenate(
        [np.zeros(zero.shape[:-1] + (1,), dtype=bool), zero[..., :-1]], axis=-1
    )
    starts = zero & ~prev
    run_id = np.cumsum(starts.astype(np.int32), axis=-1)  # 1-based on zeros
    chunks = np.zeros(zero.shape[:-1], dtype=np.int32)
    for k in range(1, WORDS_PER_LINE + 1):
        len_k = (zero & (run_id == k)).sum(axis=-1)
        chunks = chunks + (len_k + 7) // 8 * (len_k > 0)
    return (total_nz + chunks * (PREFIX_BITS + 3)).astype(np.int32)


def fpc_size_bytes(lines_bytes):
    """(…,64) uint8 -> (…,) int32 compressed size in bytes (ceil bits/8)."""
    words = bytes_to_u32(np.asarray(lines_bytes))
    return (fpc_size_bits(words) + 7) // 8


# ---------------------------------------------------------------------------
# Exact pack / unpack (host-side, per line)
# ---------------------------------------------------------------------------

def fpc_pack(line_bytes: np.ndarray | bytes) -> bytes:
    """Exact FPC encoding of one 64-byte line."""
    arr = np.frombuffer(bytes(line_bytes), dtype=np.uint8) if isinstance(
        line_bytes, (bytes, bytearray)
    ) else np.asarray(line_bytes, dtype=np.uint8)
    words = bytes_to_u32(arr).astype(np.int64)
    w_signed = ((words & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    pats = _classify_nonzero(w_signed)
    bw = BitWriter()
    i = 0
    while i < WORDS_PER_LINE:
        w = int(w_signed[i])
        u = w & 0xFFFFFFFF
        if w == 0:
            run = 0
            while i + run < WORDS_PER_LINE and int(w_signed[i + run]) == 0 and run < 8:
                run += 1
            bw.write(P_ZRUN, PREFIX_BITS)
            bw.write(run - 1, 3)
            i += run
            continue
        pat = int(pats[i])
        bw.write(pat, PREFIX_BITS)
        if pat == P_SE4:
            bw.write_signed(w, 4)
        elif pat == P_SE8:
            bw.write_signed(w, 8)
        elif pat == P_SE16:
            bw.write_signed(w, 16)
        elif pat == P_PAD16:
            bw.write((u >> 16) & 0xFFFF, 16)
        elif pat == P_HALF_SE8:
            lo = u & 0xFFFF
            hi = (u >> 16) & 0xFFFF
            bw.write_signed(((lo ^ 0x8000) - 0x8000), 8)
            bw.write_signed(((hi ^ 0x8000) - 0x8000), 8)
        elif pat == P_REPB:
            bw.write(u & 0xFF, 8)
        else:  # P_RAW
            bw.write(u, 32)
        i += 1
    return bw.getvalue()


def fpc_pack_batch(lines_bytes: np.ndarray) -> np.ndarray:
    """Vectorized exact FPC encoding of (N, 64) lines.

    Returns the 1-D uint8 concatenation of the per-line streams,
    byte-identical to ``b"".join(fpc_pack(line) for line in lines)`` but
    with no per-line Python loop (numpy batch over lines; the only loops
    are over the 16 word positions) — the path that lets multi-GB
    checkpoints use the FPC/hybrid codecs (tests pin the parity).
    """
    lines = np.ascontiguousarray(lines_bytes, dtype=np.uint8).reshape(
        -1, WORDS_PER_LINE * 4)
    n = lines.shape[0]
    if n == 0:
        return np.zeros(0, np.uint8)
    words = bytes_to_u32(lines).astype(np.int64)
    u = words & 0xFFFFFFFF
    w_signed = (u ^ 0x80000000) - 0x80000000
    zero = w_signed == 0
    pats = _classify_nonzero(w_signed)

    # zero-run chunking: a token is emitted at every run position that is
    # ≡ 0 (mod 8) within its run, covering min(remaining zeros, 8) words —
    # exactly the scalar packer's greedy 8-cap RLE.
    idx = np.arange(WORDS_PER_LINE)
    prev = np.concatenate([np.zeros((n, 1), bool), zero[:, :-1]], axis=1)
    start = zero & ~prev
    last_start = np.maximum.accumulate(np.where(start, idx, -1), axis=1)
    pos_in_run = idx[None, :] - last_start
    czl = np.zeros((n, WORDS_PER_LINE), np.int32)   # zeros from i rightward
    czl[:, -1] = zero[:, -1]
    for i in range(WORDS_PER_LINE - 2, -1, -1):
        czl[:, i] = np.where(zero[:, i], czl[:, i + 1] + 1, 0)
    chunk_start = zero & (pos_in_run % 8 == 0)
    chunk_len = np.minimum(czl, 8)

    # per-position token (value, nbits), MSB-first prefix+payload combined
    pb = _PAYLOAD_BITS_TABLE[pats].astype(np.int64)
    payload = np.zeros((n, WORDS_PER_LINE), np.int64)
    payload = np.where(pats == P_SE4, u & 0xF, payload)
    payload = np.where(pats == P_SE8, u & 0xFF, payload)
    payload = np.where(pats == P_SE16, u & 0xFFFF, payload)
    payload = np.where(pats == P_PAD16, (u >> 16) & 0xFFFF, payload)
    payload = np.where(pats == P_HALF_SE8,
                       ((u & 0xFF) << 8) | ((u >> 16) & 0xFF), payload)
    payload = np.where(pats == P_REPB, u & 0xFF, payload)
    payload = np.where(pats == P_RAW, u, payload)
    tok = ~zero | chunk_start
    val = np.where(zero, (P_ZRUN << 3) | (chunk_len - 1),
                   (pats.astype(np.int64) << pb) | payload)
    nbits = np.where(zero, PREFIX_BITS + 3, PREFIX_BITS + pb) * tok

    # bit assembly: exclusive per-line offsets, scatter MSB-first bits
    MAXB = PREFIX_BITS + 32                       # widest token (raw word)
    LINE_BITS = WORDS_PER_LINE * MAXB
    off = np.cumsum(nbits, axis=1) - nbits
    total_bits = off[:, -1] + nbits[:, -1]
    j = np.arange(MAXB)
    bits = ((val[:, :, None] >> np.maximum(
        nbits[:, :, None] - 1 - j, 0)) & 1).astype(np.uint8)
    valid = tok[:, :, None] & (j < nbits[:, :, None])
    pos = off[:, :, None] + j
    buf = np.zeros((n, LINE_BITS), np.uint8)
    flat = (np.arange(n)[:, None, None] * LINE_BITS + pos)[valid]
    buf.reshape(-1)[flat] = bits[valid]
    packed = np.packbits(buf, axis=1)             # MSB-first, as BitWriter

    line_nbytes = ((total_bits + 7) // 8).astype(np.int64)
    out_off = np.cumsum(line_nbytes) - line_nbytes
    total = int(out_off[-1] + line_nbytes[-1])
    which = np.repeat(np.arange(n), line_nbytes)
    intra = np.arange(total) - np.repeat(out_off, line_nbytes)
    return packed[which, intra]


def fpc_unpack(data: bytes) -> np.ndarray:
    """Decode FPC bytes back to a (64,) uint8 line."""
    br = BitReader(data)
    words: list[int] = []
    while len(words) < WORDS_PER_LINE:
        pat = br.read(PREFIX_BITS)
        if pat == P_ZRUN:
            run = br.read(3) + 1
            words.extend([0] * run)
        elif pat == P_SE4:
            words.append(br.read_signed(4) & 0xFFFFFFFF)
        elif pat == P_SE8:
            words.append(br.read_signed(8) & 0xFFFFFFFF)
        elif pat == P_SE16:
            words.append(br.read_signed(16) & 0xFFFFFFFF)
        elif pat == P_PAD16:
            words.append((br.read(16) << 16) & 0xFFFFFFFF)
        elif pat == P_HALF_SE8:
            lo = br.read_signed(8) & 0xFFFF
            hi = br.read_signed(8) & 0xFFFF
            words.append(((hi << 16) | lo) & 0xFFFFFFFF)
        elif pat == P_REPB:
            b = br.read(8)
            words.append(b | (b << 8) | (b << 16) | (b << 24))
        else:
            words.append(br.read(32))
    if len(words) != WORDS_PER_LINE:
        raise ValueError("FPC stream decoded to wrong word count")
    return u32_to_bytes(np.asarray(words, dtype="<u4"))
