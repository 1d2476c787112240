"""Device JPEG decode: entropy-decoded DCT coefficients -> gray frames.

Splits JPEG decoding at its natural hardware boundary. The Huffman entropy
decode is serial and branchy -> native C++ on host (native/jpeg_coeffs.cpp);
everything after — dequantization, the 8x8 inverse DCT, level shift, block
reassembly — is dense linear algebra -> batched XLA ops here (the IDCT is two
8x8 matmuls per block, which XLA batches into one matrix product).

Four transports feed the device:

* DENSE: the full ``(B, bh, bw, 64)`` int16 coefficient tensor. Simple, but
  614 KB/frame at 640x480 — 2x the raw gray bytes.
* PACKED (sparse, delta-encoded): quantized luma blocks are overwhelmingly
  zeros, so the host ships one (gap uint8, value int8) pair per nonzero in
  the batch's flat coefficient space (gaps > 255 bridged by zero-value
  fillers; the rare |v| > 127 ride an int16 spill side stream), ~3 bytes
  per nonzero = ~40-60 KB/frame on real streams. The device reconstructs
  positions with ONE cumsum and materializes the dense tensor with ONE
  sorted-unique scatter (+ the tiny spill add) — expansion work scales
  with the NONZEROS, not the dense size.
* TDELTA (default; round 5): the production workload is a statically
  mounted camera watching a slowly-deforming gel, so consecutive frames'
  QUANTIZED coefficients are overwhelmingly identical (measured 95.7% of
  blocks bit-identical on the q70 480p bench stream). TDELTA ships each
  block's TEMPORAL coefficient delta (frame 0: absolute, so every batch is
  self-contained) through one SPLIT-style VLC byte stream over the
  zmax-slot zigzag space (slot 0 = DC; a two-byte escape skips up to 263
  silent blocks). The device scatters the deltas and reconstructs with ONE
  cumsum over the frame axis — deltas telescope, every prefix sum IS a
  real frame's coefficients (no overflow), and per-frame qtables stay
  exact because deltas live in quantized space. ~2.8 KB/frame on the q70
  bench stream (8x below SPLIT); adversarial noise streams degrade
  boundedly to ~2x SPLIT's entries (the delta support is at most
  nnz(cur) + nnz(prev)) — pick SPLIT for scene-independent byte ceilings.
* SPLIT (round 4, VLC'd + adaptive-DC'd in round 5): PACKED's
  pairs still waste bytes on both entry classes — block DCs (~25% of
  nonzeros) are large values needing no gap, ACs have tiny zigzag
  run-lengths and small values. DCs ride a dense per-block NIBBLE delta
  lane whose predictor the encoder picks per frame (spatial = previous
  block, temporal = previous frame; a flag nibble per frame — the device
  rebuilds with a flag-segmented prefix sum, no scatter at all); ACs ride
  a self-synchronizing 1-or-2-byte VLC in ZIGZAG order (3-bit gap + 5-bit
  value short form; an EXT code carries int8 values, an escape code skips
  whole empty blocks), the inverse zigzag permutation folded into the
  IDCT basis matrix for free. uint16-gap int16 spill side streams carry
  the rare clamps (|AC| > 127 / |DC delta| > 7 residuals). ~22.4 KB/frame
  on the q70 480p bench stream (26.0 on the round-4 default-quality
  stream that shipped 33.4 then) — the fewest bytes of the three.

The SPLIT transport additionally takes a ``zmax`` band limit (round 5):
AC coefficients at zigzag scan index >= zmax are dropped at the host
encoder and the position space shrinks to zmax-1 slots per block (the
IDCT basis matmul shrinks with it). zmax=64 is exact; lower values are an
OPT-IN tracking-grade profile for link-bound ingest (12.4 KB/frame at
zmax=15 on the q70 bench stream vs 22.4 exact). The physics: the
pipeline's blurred stages (DoG band, NCC, peaks) see nothing — a Gaussian
blur of sigma >= 4.56 px (marker_detection.py:118-124) attenuates every
8x8 DCT mode with k+l >= 5 below 1e-9, and zmax=15 keeps all modes with
k+l <= 4. The PHOTOMETRIC MOMENT stage however reads raw pixels, where
the dropped tail is real marker-edge energy: measured end to end on a
rendered q70 sensor stream, zmax=15 keeps every marker detected and
matched (centroid shift p99 ~1.0 px vs the exact decode; the q70 floor
itself is ~0.4 px) but drifts photometric AXES by up to ~6 px p99 —
diameters feed depth reconstruction, so the band limit is NOT the
default and never headlines the bench (tests/test_jpeg.py band-limit
envelope pins the contract).

This is the framework's answer to the host-decode ingest wall: entropy
decode alone is several times cheaper than a full libjpeg decode, and the
FLOP-heavy rest runs on the device.

Luma only: the perception pipeline is grayscale (marker_detection.py:114),
and libjpeg's IMREAD_GRAYSCALE output is exactly the Y channel.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp


class HostPacked(NamedTuple):
    """Host-side result of the PACKED entropy decode — pure numpy, safe to
    produce on any thread. ``MjpegBatchDecoder.packed_to_device`` turns it
    into device frames on the consumer thread (io/video.device_feed)."""
    gaps: np.ndarray
    vals: np.ndarray
    sgaps: np.ndarray
    sdeltas: np.ndarray
    qtables: np.ndarray
    height: int
    width: int
    grid: tuple[int, int]
    stats: dict


class HostDense(NamedTuple):
    """Host-side result of the DENSE entropy decode (see HostPacked)."""
    coeffs: np.ndarray
    qtables: np.ndarray
    height: int
    width: int
    stats: dict


class HostSplit(NamedTuple):
    """Host-side result of the SPLIT entropy decode (see HostPacked): DC
    deltas ride a dense int8 per-block stream, ACs a 1-byte (3-bit gap,
    5-bit value) stream — ~40% fewer bytes than HostPacked. ``zmax``
    is the band limit the streams were encoded with (module header)."""
    ac: np.ndarray
    dc: np.ndarray
    sgaps: np.ndarray
    sdeltas: np.ndarray
    dgaps: np.ndarray
    ddeltas: np.ndarray
    qtables: np.ndarray
    height: int
    width: int
    grid: tuple[int, int]
    stats: dict
    zmax: int = 64


class HostTDelta(NamedTuple):
    """Host-side result of the TDELTA entropy decode (see HostPacked): ONE
    VLC byte stream of temporal coefficient deltas (slot 0 = DC) + its
    spill side stream. ``zmax`` is the band limit (module header)."""
    ac: np.ndarray
    sgaps: np.ndarray
    sdeltas: np.ndarray
    qtables: np.ndarray
    height: int
    width: int
    grid: tuple[int, int]
    stats: dict
    zmax: int = 64

# Growable-capacity return codes from native/jpeg_coeffs.cpp. Any OTHER
# nonzero code is a hard parse failure — retrying with bigger buffers would
# just re-parse a malformed JPEG with progressively larger allocations.
_RC_BLOCK_CAP = -11
_RC_VAL_CAP = -100
_RC_SPILL_CAP = -102
_RC_AC_CAP = -104
_RC_AC_SPILL_CAP = -105
_RC_DC_SPILL_CAP = -106


def _idct8_basis() -> np.ndarray:
    """A[i, k] = alpha(k) cos((2i+1) k pi / 16): pixels = A @ C @ A^T."""
    k = np.arange(8)
    i = np.arange(8)[:, None]
    A = np.cos((2 * i + 1) * k * np.pi / 16.0)
    A *= np.where(k == 0, np.sqrt(1.0 / 8.0), np.sqrt(2.0 / 8.0))
    return A.astype(np.float32)


# Natural index of each zigzag scan position (T.81 figure A.6) — must match
# native/jpeg_coeffs.cpp:kZigzag. The SPLIT transport keeps coefficients in
# zigzag order end to end (the scan's run-lengths stay tiny, which its 3-bit
# gaps exploit); the inverse permutation folds into the IDCT basis and the
# per-frame qtable reorder below at zero device cost.
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)


@functools.cache
def _idct64_basis(zigzag: bool = False) -> np.ndarray:
    """Flat 2D-IDCT map: ``M[(k,l), (i,j)] = A[i,k] A[j,l]`` (= kron(A, A)
    rearranged), so ``pixels_flat = coeffs_flat @ M`` in one (N, 64) @
    (64, 64) matmul. ``zigzag`` row-permutes M so zigzag-ordered
    coefficient vectors multiply directly."""
    A = _idct8_basis()
    M = np.einsum("ik,jl->klij", A, A).reshape(64, 64).astype(np.float32)
    return M[_ZIGZAG] if zigzag else M


def _dequant_idct(coeffs: jnp.ndarray, qtable: jnp.ndarray,
                  height: int, width: int,
                  zigzag: bool = False) -> jnp.ndarray:
    """``(B, bh, bw, 64)`` float coefficients -> ``(B, height, width)`` gray.

    The 2D 8x8 IDCT is one linear map on the flat 64-coefficient vector, so
    the whole batch runs as ONE ``(B*bh*bw, 64) @ (64, 64)`` matmul
    instead of per-block 8x8 einsums. HIGHEST precision keeps f32
    products: coefficient*basis products reach ~2e3, and a reduced-precision
    matmul (bf16 or TF32) would cost several gray levels vs libjpeg (tests
    pin max 2.0 absolute).

    ``zigzag`` says how ``coeffs``' last axis is ordered. Internally the
    contraction ALWAYS runs in zigzag order (natural-order inputs are
    permuted first — a cheap static relayout): float accumulation order is
    part of the transports' bitwise-identical-output contract, so every
    transport must sum the same products in the same sequence.

    When ``zigzag`` is set the last axis may be a zigzag PREFIX of length
    Z < 64 (the band-limited split transport): the contraction then uses
    the first Z rows of the basis — mathematically identical to padding
    the remaining coefficients with zeros, at Z/64 the matmul FLOPs.
    """
    zz = jnp.asarray(_ZIGZAG)
    if not zigzag:
        coeffs = coeffs[..., zz]
    z = coeffs.shape[-1]
    M = jnp.asarray(_idct64_basis(True))[:z]
    b, bh, bw, _ = coeffs.shape
    q = qtable.astype(jnp.float32)[..., zz[:z]]  # tables stored natural-order
    if q.ndim == 2:
        q = q[:, None, None, :]
    px = jax.lax.dot_general((coeffs * q).reshape(b, bh * bw, z), M,
                             (((2,), (0,)), ((), ())),
                             precision=jax.lax.Precision.HIGHEST) + 128.0
    # (B, bh, bw, 8, 8) -> (B, bh*8, bw*8): one bulk relayout.
    img = (px.reshape(b, bh, bw, 8, 8).transpose(0, 1, 3, 2, 4)
           .reshape(b, bh * 8, bw * 8))
    img = jnp.clip(jnp.floor(img + 0.5), 0.0, 255.0)
    return img[:, :height, :width]


@functools.partial(jax.jit, static_argnames=("height", "width"))
def idct_frames(coeffs: jnp.ndarray, qtable: jnp.ndarray, *,
                height: int, width: int) -> jnp.ndarray:
    """Quantized luma coefficients -> gray frames, all on device.

    Args:
      coeffs: ``(B, bh, bw, 64)`` int16, natural (de-zigzagged) order.
      qtable: ``(B, 64)`` or ``(64,)`` quantization table(s), natural order
        (PER FRAME: MJPEG writers adapt quality frame to frame).
      height/width: true image dims (block grid may overhang).

    Returns float32 frames ``(B, height, width)`` in 0..255, matching
    libjpeg within IDCT rounding (~±1 gray level).
    """
    return _dequant_idct(coeffs.astype(jnp.float32), qtable, height, width)


@functools.partial(jax.jit, static_argnames=("height", "width", "grid"))
def delta_idct_frames(gaps: jnp.ndarray, vals: jnp.ndarray,
                      sgaps: jnp.ndarray, sdeltas: jnp.ndarray,
                      qtable: jnp.ndarray, *, height: int, width: int,
                      grid: tuple[int, int]) -> jnp.ndarray:
    """Delta-packed sparse coefficients -> gray frames, all on device.

    Args:
      gaps: ``(cap,)`` uint8 strictly-positive position deltas in the flat
        coefficient space (first entry relative to -1); zero-value fillers
        bridge gaps > 255. Tail padding must be (gap=255, value=0) so the
        implied positions keep growing past the tensor and drop.
      vals: ``(cap,)`` int8 clamped coefficients (pairs with ``gaps``).
      sgaps/sdeltas: the spill side stream (uint8 gaps / int16 remainders)
        for coefficients outside [-127, 127], same conventions EXCEPT tail
        padding, which is (gap=0, delta=0): spills are ADDS, so a zero add
        is a no-op wherever it lands (even wrapped to -1 when a stream has
        no real spills) — unlike escape-style pads, zero-gap pads cannot
        overrun the int32 position space no matter how many there are.
      qtable: ``(B, 64)`` per-frame quantization tables, natural order.
      height/width: true image dims; grid: ``(bh, bw)`` block grid.

    Returns float32 frames ``(B, height, width)`` in 0..255 — identical to
    :func:`idct_frames` on the equivalent dense tensor (same math, bitwise).

    Why scatter: positions are strictly increasing and unique by
    construction, so the scatter lowers to a streaming sorted write that
    scales with the NONZERO count. The earlier bitmask transport expanded
    with one gather per dense OUTPUT element — 78M scalar gathers per
    256-frame batch.
    """
    bh, bw = grid
    b = qtable.shape[0]
    total = b * bh * bw * 64
    pos = jnp.cumsum(gaps.astype(jnp.int32)) - 1
    flat = jnp.zeros(total, jnp.int16).at[pos].set(
        vals.astype(jnp.int16), mode="drop", unique_indices=True,
        indices_are_sorted=True)
    spos = jnp.cumsum(sgaps.astype(jnp.int32)) - 1
    # unique_indices=False: the (gap=0, delta=0) tail pads repeat the last
    # real position (zero adds are no-ops, so correctness is unaffected, but
    # claiming uniqueness on duplicates would be UB).
    flat = flat.at[spos].add(sdeltas, mode="drop", unique_indices=False,
                             indices_are_sorted=True)
    return _dequant_idct(flat.reshape(b, bh, bw, 64).astype(jnp.float32),
                         qtable, height, width)


@functools.partial(jax.jit,
                   static_argnames=("height", "width", "grid", "zmax"))
def split_idct_frames(ac: jnp.ndarray, dc: jnp.ndarray, sgaps: jnp.ndarray,
                      sdeltas: jnp.ndarray, dgaps: jnp.ndarray,
                      ddeltas: jnp.ndarray, qtable: jnp.ndarray, *,
                      height: int, width: int, grid: tuple[int, int],
                      zmax: int = 64) -> jnp.ndarray:
    """SPLIT-transport streams -> gray frames, all on device.

    Args:
      ac: ``(cap,)`` uint8 AC stream, 1 OR 2 bytes per entry
        (native/jpeg_coeffs.cpp SplitSink header) — first byte: low 3 bits
        gap-1 (gap 1..8 in the (zmax-1)-slot-per-block ZIGZAG AC position
        space, pos = block*(zmax-1) + zigzag_index-1: scan order keeps
        JPEG's own run-lengths, so gaps almost always fit 3 bits), high 5
        bits the value code: -14..15 = the value itself (SHORT); -16 = an
        escape advancing (low3+1)*(zmax-1) positions with no emission;
        -15 = EXT, the next byte is the value as int8. Tail padding must
        be 0x87 (escape, 8 blocks) so implied positions overrun and drop.

        Decoding a variable-length stream with vector ops only: after any
        byte whose code is not EXT the next byte starts an entry, so
        within each run of consecutive EXT-code bytes entry starts simply
        alternate — ``starts`` below is a parity scan (one cummax + cheap
        elementwise), ext values arrive by a static shift of the stream,
        and non-start bytes ride the same scatter with step 0 / value 0
        (the scatter becomes a sorted ADD; each position still receives
        exactly one nonzero). No per-entry gathers.
      dc: ``(B*ceil((blocks+1)/2),)`` uint8 per-block DC delta NIBBLE lane
        (nibble 2k = low nibble of byte k; frame lanes are whole bytes).
        Nibble 0 of each frame is the predictor FLAG the encoder chose
        for that frame (0 = spatial: each block vs the previous block,
        block 0 vs 0; 1 = temporal: each block vs the same block of the
        previous frame); block j rides nibble j+1 as its delta clamped to
        [-7, 7]. Residuals ride the dgaps/ddeltas spill stream. Dense, no
        padding. See native/jpeg_coeffs.cpp SplitSink.
      sgaps/sdeltas: AC spill stream (uint16 gaps over AC positions /
        int16 remainders for |v| > 15); tail padding (gap=0, delta=0) —
        zero adds are no-ops wherever they land, so pads can never overrun
        the int32 position space (escape-style 65535 pads did on spill-heavy
        q70+ streams). Spills are sparse, so 16-bit gaps avoid the ~50%
        filler overhead uint8 gaps paid.
      dgaps/ddeltas: DC spill stream (uint16 gaps over block indices /
        int16 remainders for |delta| > 127); tail padding (0, 0).
      qtable: ``(B, 64)`` per-frame quantization tables, natural order.
      height/width: true image dims; grid: ``(bh, bw)`` block grid.
      zmax: the band limit the streams were encoded with (module header).
        64 = exact decode, bitwise-identical to :func:`idct_frames` on the
        equivalent dense tensor; < 64 = detect-grade decode, identical to
        the dense path with zigzag indices >= zmax zeroed.

    The AC scatter keeps the sorted-unique streaming form (see
    :func:`delta_idct_frames`); escapes and fillers land on real positions
    with value 0, which the pre-zeroed tensor absorbs. DCs skip scattering
    entirely: one per-frame cumsum over the dense delta lane, then a
    concatenate puts the DC column next to the zmax-1 AC columns.
    """
    bh, bw = grid
    b = qtable.shape[0]
    blocks = bh * bw
    ns = zmax - 1
    low = (ac & 7).astype(jnp.int32)
    v5 = ((ac >> 3).astype(jnp.int32) ^ 16) - 16  # sign-extend 5 bits
    ext = v5 == -15
    # Entry starts by run parity over the EXT flag: byte i starts an entry
    # iff (i - m[i-1]) is odd, where m[i] = last index <= i with ext False
    # (any byte after a non-EXT byte is a start; within an EXT-flag run
    # starts alternate — the framing self-synchronizes, so the flag's value
    # on raw ext-VALUE bytes is irrelevant).
    idx = jnp.arange(ac.shape[0], dtype=jnp.int32)
    m = jax.lax.cummax(jnp.where(ext, jnp.int32(-1), idx))
    m_prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), m[:-1]])
    start = ((idx - m_prev) & 1) == 1
    esc = (v5 == -16) & start
    is_ext = ext & start
    nxt = jnp.concatenate([ac[1:], ac[-1:]]).astype(jnp.int8)
    val = jnp.where(is_ext, nxt.astype(jnp.int32), jnp.where(esc, 0, v5))
    val = jnp.where(start, val, 0).astype(jnp.int16)
    step = jnp.where(start, jnp.where(esc, (low + 1) * ns, low + 1), 0)
    pos = jnp.cumsum(step) - 1
    # ADD, not SET: ext value bytes carry step 0 / value 0 and repeat their
    # starter's position — every real position still receives exactly one
    # nonzero contribution on the pre-zeroed tensor.
    flat = jnp.zeros(b * blocks * ns, jnp.int16).at[pos].add(
        val, mode="drop", unique_indices=False, indices_are_sorted=True)
    spos = jnp.cumsum(sgaps.astype(jnp.int32)) - 1
    # unique_indices=False on both spill adds: (0, 0) tail pads repeat the
    # last real position (zero adds are no-ops; claiming uniqueness on
    # duplicates would be UB).
    flat = flat.at[spos].add(sdeltas, mode="drop", unique_indices=False,
                             indices_are_sorted=True)
    # DC nibble lane -> per-frame flag + clamped deltas (nibble 2k = low
    # nibble of byte k; sign-extend 4 bits), then the spill residuals.
    bpf2 = (blocks + 2) // 2  # ceil((blocks + 1) / 2): flag + blocks
    dcb = dc.reshape(b, bpf2)
    nib = jnp.stack([dcb & 15, dcb >> 4], axis=-1).reshape(b, 2 * bpf2)
    spatial = (nib[:, 0] & 1) == 0
    spatial = spatial.at[0].set(True)  # frame 0 has no temporal predictor
    d = ((nib[:, 1:blocks + 1].astype(jnp.int32) ^ 8) - 8)
    d = d.reshape(b * blocks)
    dpos = jnp.cumsum(dgaps.astype(jnp.int32)) - 1
    d = d.at[dpos].add(ddeltas.astype(jnp.int32), mode="drop",
                       unique_indices=False, indices_are_sorted=True)
    # Flag-segmented reconstruction: spatial frames are self-contained
    # (cumsum over blocks = segment leaders); temporal frames stack their
    # deltas on the leader via a frame-axis prefix sum rebased per segment
    # (one row-take per frame — row gathers amortize where per-ELEMENT
    # gathers do not).
    d = d.reshape(b, blocks)
    lead = jnp.cumsum(d, axis=-1)
    base = jnp.where(spatial[:, None], lead, d)
    csum = jnp.cumsum(base, axis=0)
    seg = jax.lax.cummax(jnp.where(spatial, jnp.arange(b, dtype=jnp.int32),
                                   jnp.int32(0)))
    dcv = (csum - jnp.take(csum, seg, axis=0)
           + jnp.take(base, seg, axis=0)).astype(jnp.int16)
    # [dc | zz1..zz(zmax-1)] IS the zigzag-ordered coefficient (prefix)
    # vector (zigzag position 0 is the DC); the inverse permutation rides
    # the IDCT basis, whose row count shrinks with the band limit.
    coeffs = jnp.concatenate([dcv.reshape(b * blocks, 1),
                              flat.reshape(b * blocks, ns)], axis=1)
    return _dequant_idct(coeffs.reshape(b, bh, bw, zmax).astype(jnp.float32),
                         qtable, height, width, zigzag=True)


@functools.partial(jax.jit,
                   static_argnames=("height", "width", "grid", "zmax"))
def tdelta_idct_frames(ac: jnp.ndarray, sgaps: jnp.ndarray,
                       sdeltas: jnp.ndarray, qtable: jnp.ndarray, *,
                       height: int, width: int, grid: tuple[int, int],
                       zmax: int = 64) -> jnp.ndarray:
    """TDELTA-transport stream -> gray frames, all on device.

    The stream encodes each block's TEMPORAL coefficient delta against the
    previous frame (frame 0: absolute) in the zmax-slot-per-block zigzag
    space, slot 0 = DC (native/jpeg_coeffs.cpp TDeltaSink header).
    Reconstruction telescopes: scatter the deltas into the pre-zeroed
    (B, blocks*zmax) tensor, cumsum over the FRAME axis (every prefix sum
    is a real frame's quantized coefficients, so int16 cannot overflow),
    then the shared zigzag dequant-IDCT. Per-frame qtables stay exact —
    deltas live in quantized space and each frame dequantizes with its own
    table after the cumsum.

    Args:
      ac: ``(cap,)`` uint8 VLC stream — first byte: low 3 bits gap-1
        (gap 1..8), high 5 bits the value code: -14..15 = the delta
        (SHORT); -15 = EXT, next byte is the delta as int8; -16 = escape:
        low 3 bits k-1 with k in 1..7 skips k whole blocks (one byte),
        k == 8 is the TWO-byte form whose next byte B skips 8+B blocks.
        Entry starts are recovered by the parity scan of
        :func:`split_idct_frames`, extended so BOTH payload-carrying first
        bytes (EXT and two-byte escape) mark the following byte as
        payload. Tail padding must be 0x86 (escape, 7 blocks) so implied
        positions overrun and drop.
      sgaps/sdeltas: spill side stream (uint16 gaps / int16 remainders for
        |delta| > 127); tail padding (0, 0) — zero adds are no-ops.
      qtable: ``(B, 64)`` per-frame quantization tables, natural order.
      height/width: true image dims; grid: ``(bh, bw)`` block grid.
      zmax: band limit (64 = exact decode, bitwise-identical to
        :func:`idct_frames`; < 64 = zigzag indices >= zmax zeroed).

    Returns float32 frames ``(B, height, width)`` in 0..255.
    """
    bh, bw = grid
    b = qtable.shape[0]
    blocks = bh * bw
    ns = zmax
    low = (ac & 7).astype(jnp.int32)
    v5 = ((ac >> 3).astype(jnp.int32) ^ 16) - 16  # sign-extend 5 bits
    # A byte whose code marks one payload byte: EXT, or the 2-byte escape.
    carries = (v5 == -15) | ((v5 == -16) & (low == 7))
    idx = jnp.arange(ac.shape[0], dtype=jnp.int32)
    m = jax.lax.cummax(jnp.where(carries, jnp.int32(-1), idx))
    m_prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), m[:-1]])
    start = ((idx - m_prev) & 1) == 1
    esc = (v5 == -16) & start
    esc2 = esc & (low == 7)
    is_ext = (v5 == -15) & start
    nxt = jnp.concatenate([ac[1:], ac[-1:]])
    val = jnp.where(is_ext, nxt.astype(jnp.int8).astype(jnp.int32),
                    jnp.where(esc, 0, v5))
    val = jnp.where(start, val, 0).astype(jnp.int16)
    skip = jnp.where(esc2, (8 + nxt.astype(jnp.int32)) * ns,
                     (low + 1) * ns)
    step = jnp.where(start, jnp.where(esc, skip, low + 1), 0)
    pos = jnp.cumsum(step) - 1
    flat = jnp.zeros(b * blocks * ns, jnp.int16).at[pos].add(
        val, mode="drop", unique_indices=False, indices_are_sorted=True)
    spos = jnp.cumsum(sgaps.astype(jnp.int32)) - 1
    flat = flat.at[spos].add(sdeltas, mode="drop", unique_indices=False,
                             indices_are_sorted=True)
    # Telescoping temporal reconstruction: one cumsum over the frame axis.
    coeffs = jnp.cumsum(flat.reshape(b, blocks * ns), axis=0)
    return _dequant_idct(coeffs.reshape(b, bh, bw, ns).astype(jnp.float32),
                         qtable, height, width, zigzag=True)


def _bucket(n: int, minimum: int = 1 << 12) -> int:
    """Smallest 9/8-ratio geometric bucket >= n: pads device-bound streams
    so jit shapes change rarely (a steady scene lands in 1-2 buckets, each a
    one-time compile behind the persistent cache) while capping the padding
    overhead at 12.5% — a power-of-two bucket would average ~30% extra
    bytes to the device."""
    b = minimum
    while b < n:
        b += max(minimum, b >> 3)
    return b


class MjpegBatchDecoder:
    """Batch JPEG -> device gray frames via the native entropy decoder.

    Stateless w.r.t. the stream apart from the geometry learned from the
    first frame (an MJPEG stream's frames share it). ``decode`` ships the
    dense coefficient tensor; ``decode_packed`` ships the sparse transport
    (see module docstring) and records its byte accounting in
    ``last_stats``. Construction raises when the native library can't be
    built — callers should then use host decode (io/video.MjpegAviSource).
    """

    def __init__(self, workers: int | None = None):
        """``workers``: host threads for the packed entropy decode (frames
        are independent). Default = cpu count; 1 = the serial path. The
        output is semantically identical either way (same positions/values;
        filler placement may differ at slice joins)."""
        import os
        from vision_basedsensor_tpu.native import load_jpeg_lib
        self._lib = load_jpeg_lib()
        if self._lib is None:
            raise RuntimeError("native JPEG decoder unavailable (no C++ "
                               "compiler); use host decode")
        self._workers = (os.cpu_count() or 1) if workers is None else workers
        self._meta: tuple | None = None  # (w, h, bw, bh)
        self._qtable: np.ndarray | None = None
        self._cap = 0
        self._scap = 0
        # Persistent packed-output buffers: reallocating ~15 MB per batch
        # would cost the 1-core host real page-fault time at 1000 fps.
        self._gaps: np.ndarray | None = None
        self._vals: np.ndarray | None = None
        self._sgaps: np.ndarray | None = None
        self._sdeltas: np.ndarray | None = None
        # Split-transport buffers (ac bytes, dc deltas, the two spills).
        self._accap = 0
        self._ascap = 0
        self._dscap = 0
        self._ac: np.ndarray | None = None
        self._dc: np.ndarray | None = None
        self._asg: np.ndarray | None = None
        self._asd: np.ndarray | None = None
        self._dsg: np.ndarray | None = None
        self._dsd: np.ndarray | None = None
        # Temporal-delta transport buffers (one VLC stream + one spill).
        self._tcap = 0
        self._tscap = 0
        self._tac: np.ndarray | None = None
        self._tsg: np.ndarray | None = None
        self._tsd: np.ndarray | None = None
        self.last_stats: dict | None = None

    @staticmethod
    def _sof_dims(jpeg: bytes) -> tuple[int, int] | None:
        """(width, height) from the SOF header — cheap enough to run per
        BATCH so a stream whose camera reconfigures geometry mid-session
        triggers a re-probe instead of silently reshaping new coefficients
        with stale geometry (review finding: the old cached-forever meta
        returned valid-shaped garbage frames, max error ~180 gray levels,
        and downstream shape guards never fired). Shared scanner:
        io/mjpeg.py:sof_dims."""
        from vision_basedsensor_tpu.io.mjpeg import sof_dims
        return sof_dims(jpeg)

    def _ensure_meta(self, first_jpeg: bytes) -> None:
        """Learn (or re-learn) the stream geometry from the batch's first
        frame. The SOF sniff catches pixel-dimension changes; block-grid
        changes at the SAME pixel dims (chroma subsampling switch, e.g.
        4:4:4 -> 4:2:0 at w % 16 != 0) are caught after the batch call by
        comparing the returned meta — see the retry in decode[_packed]."""
        if self._meta is None:
            self._probe(first_jpeg)
            return
        dims = self._sof_dims(first_jpeg)
        if dims is not None and dims != (self._meta[0], self._meta[1]):
            self._probe(first_jpeg)
            self._cap = self._scap = 0
            self._accap = self._ascap = self._dscap = 0

    def _relearn_or_raise(self, jpegs: list[bytes], got: int, n: int) -> None:
        """After a batch call that failed or returned a different geometry:
        re-probe frame 0 to distinguish a block-grid change at the same
        pixel dims (retry with fresh meta) from a genuinely malformed frame
        (raise the original batch error)."""
        old = self._meta
        self._probe(jpegs[0])           # raises if frame 0 is malformed
        if self._meta == old and got != n:
            raise ValueError(f"JPEG batch decode failed at frame {got}")
        self._cap = self._scap = 0
        self._accap = self._ascap = self._dscap = 0

    def _probe(self, jpeg: bytes) -> None:
        import ctypes
        meta = (ctypes.c_int32 * 4)()
        q = (ctypes.c_uint16 * 64)()
        # Start with 1080p block capacity and grow on demand — the old
        # fixed 8Kx8K probe buffer was a 134 MB host allocation per decoder
        # (significant on the weak single-core hosts this path targets).
        cap = (1920 // 8) * (1088 // 8)
        while True:
            buf = np.empty((cap, 64), np.int16)
            rc = self._lib.vbs_jpeg_y_coeffs(
                jpeg, len(jpeg),
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), cap,
                meta, q)
            if rc == 0:
                break
            # Only grow for the capacity code — any other rc is a parse
            # failure, and re-parsing a malformed JPEG with progressively
            # larger allocations is wasted work on a weak host.
            if rc != _RC_BLOCK_CAP or cap >= (8192 // 8) ** 2:
                raise ValueError(f"JPEG parse failed (rc={rc})")
            cap *= 4
        self._meta = (meta[0], meta[1], meta[2], meta[3])
        self._qtable = np.array(q[:], np.uint16)

    def _batch_args(self, jpegs: list[bytes]):
        import ctypes
        data = b"".join(jpegs)
        n = len(jpegs)
        offsets = np.zeros(n, np.int64)
        sizes = np.zeros(n, np.int32)
        pos = 0
        for i, j in enumerate(jpegs):
            offsets[i] = pos
            sizes[i] = len(j)
            pos += len(j)
        return (data,
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)

    def decode(self, jpegs: list[bytes]) -> jnp.ndarray:
        """Decode a batch of same-geometry JPEGs to ``(B, H, W)`` float32
        via the DENSE coefficient transport."""
        return self.dense_to_device(self.entropy_decode_dense(jpegs))

    def dense_to_device(self, hd: HostDense) -> jnp.ndarray:
        """Device half of :meth:`decode` — jit dispatch, MAIN thread only."""
        self.last_stats = hd.stats
        return idct_frames(jnp.asarray(hd.coeffs), jnp.asarray(hd.qtables),
                           height=hd.height, width=hd.width)

    def entropy_decode_dense(self, jpegs: list[bytes]) -> HostDense:
        """Host half of :meth:`decode` — pure numpy + native call, safe on a
        prefetch thread (no jax dispatch)."""
        import ctypes
        self._ensure_meta(jpegs[0])
        args = self._batch_args(jpegs)
        n = args[-1]
        for attempt in range(2):
            w, h, bw, bh = self._meta
            blocks = bw * bh
            coeffs = np.empty((n, bh, bw, 64), np.int16)
            meta = (ctypes.c_int32 * 4)()
            qtables = np.empty((n, 64), np.uint16)
            got = self._lib.vbs_mjpeg_batch_y_coeffs(
                *args,
                coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), blocks,
                meta, qtables.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
            if got == n and (meta[0], meta[1], meta[2],
                             meta[3]) == self._meta:
                break
            if attempt > 0:
                raise ValueError(f"JPEG batch decode failed at frame {got}")
            # A block-grid change at the same pixel dims (chroma subsampling
            # switch) either fails the call (grid grew past the passed
            # capacity) or succeeds with a different returned meta; both
            # re-learn geometry and retry once with correct shapes.
            self._relearn_or_raise(jpegs, got, n)
        stats = {"transport": "dense", "frames": n,
                 "bytes_shipped": coeffs.nbytes + qtables.nbytes}
        self.last_stats = stats
        return HostDense(coeffs, qtables, h, w, stats)

    def decode_packed(self, jpegs: list[bytes]) -> jnp.ndarray:
        """Decode a batch to ``(B, H, W)`` float32 via the PACKED
        (delta-encoded sparse) transport — identical output to
        :meth:`decode`, a fraction of the host->device bytes."""
        return self.packed_to_device(self.entropy_decode_packed(jpegs))

    def packed_to_device(self, hp: HostPacked) -> jnp.ndarray:
        """Device half of :meth:`decode_packed` — jit dispatch, MAIN thread
        only (see HostPacked)."""
        self.last_stats = hp.stats
        return delta_idct_frames(
            jnp.asarray(hp.gaps), jnp.asarray(hp.vals), jnp.asarray(hp.sgaps),
            jnp.asarray(hp.sdeltas), jnp.asarray(hp.qtables),
            height=hp.height, width=hp.width, grid=hp.grid)

    def entropy_decode_packed(self, jpegs: list[bytes]) -> HostPacked:
        """Host half of :meth:`decode_packed` — pure numpy + native call,
        safe on a prefetch thread (no jax dispatch)."""
        import ctypes
        self._ensure_meta(jpegs[0])
        n = len(jpegs)
        args = None
        for attempt in range(2):
            w, h, bw, bh = self._meta
            blocks = bw * bh
            # The device-side position reconstruction is an int32 cumsum
            # over the batch's flat coefficient space (int64 is unavailable
            # without x64 mode); past 2^31 positions would wrap negative and
            # the scatter's mode="drop" would silently discard coefficients.
            # Checked BEFORE the payload join below — the clean rejection
            # must not first concatenate hundreds of MB on a weak host.
            if n * blocks * 64 >= 2 ** 31:
                raise ValueError(
                    f"packed transport: batch of {n} frames x {blocks} "
                    f"blocks exceeds the int32 position space "
                    f"({n * blocks * 64} >= 2^31); split the batch")
            if args is None:
                args = self._batch_args(jpegs)
            if self._cap == 0:
                # First call: size the streams for typical sparsity (~5
                # entries per block incl. fillers, few spills) and grow on
                # the specific capacity rc codes. Hard ceiling = every
                # coefficient nonzero (fillers can't exceed the nonzero
                # count + one per block).
                self._cap = 5 * blocks * n
                self._scap = max(blocks * n // 16, 1 << 12)
            meta = (ctypes.c_int32 * 4)()
            qtables = np.empty((n, 64), np.uint16)
            counts = np.zeros(2, np.int64)
            while True:
                if self._gaps is None or self._gaps.size < self._cap:
                    self._gaps = np.empty(self._cap, np.uint8)
                    self._vals = np.empty(self._cap, np.int8)
                if self._sgaps is None or self._sgaps.size < self._scap:
                    self._sgaps = np.empty(self._scap, np.uint8)
                    self._sdeltas = np.empty(self._scap, np.int16)
                call_args = (
                    *args,
                    self._gaps.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    self._vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                    self._cap,
                    self._sgaps.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint8)),
                    self._sdeltas.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_int16)),
                    self._scap,
                    counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    blocks, meta,
                    qtables.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
                if self._workers > 1:
                    got = self._lib.vbs_mjpeg_batch_y_coeffs_delta_mt(
                        *call_args, self._workers)
                else:
                    got = self._lib.vbs_mjpeg_batch_y_coeffs_delta(*call_args)
                if got == n:
                    break
                if got == _RC_VAL_CAP:
                    self._cap = min(2 * self._cap, 66 * blocks * n)
                elif got == _RC_SPILL_CAP:
                    self._scap = min(2 * self._scap, 66 * blocks * n)
                else:
                    break
            if got == n and (meta[0], meta[1], meta[2],
                             meta[3]) == self._meta:
                break
            if attempt > 0:
                raise ValueError(f"JPEG batch decode failed at frame {got}")
            # Block-grid change at the same pixel dims: re-learn and retry
            # once with correct shapes (see decode()).
            self._relearn_or_raise(jpegs, got, n)
        e_n, s_n = int(counts[0]), int(counts[1])
        e_b = min(_bucket(e_n), self._gaps.size)
        s_b = min(_bucket(s_n), self._sgaps.size)
        # The main stream's (gap=255, value=0) tail fillers keep climbing
        # past the tensor end; they must stay inside int32 or they wrap — a
        # multi-wrap could land a zero back INSIDE the valid range and
        # violate the scatter's unique-sorted-index contract. (Spill pads
        # are (0, 0) — zero-gap zero-adds can't overrun anything.) Real
        # sparsity never gets close (256x480p: ~78M + 255*~600k);
        # adversarially dense inputs fail cleanly here instead of
        # corrupting.
        if n * blocks * 64 + 255 * (e_b - e_n) >= 2 ** 31:
            raise ValueError(
                "packed transport: tail-filler positions would exceed the "
                "int32 position space; split the batch")
        # Copies (the async device transfer must not race the next batch
        # overwriting the persistent buffers) with deterministic tail
        # padding: (gap=255, value=0) keeps the implied positions strictly
        # increasing off the end of the tensor, where mode="drop" kills
        # them — uninitialized tail gaps could collide with real positions.
        gaps = self._gaps[:e_b].copy()
        vals = self._vals[:e_b].copy()
        gaps[e_n:] = 255
        vals[e_n:] = 0
        sgaps = self._sgaps[:s_b].copy()
        sdeltas = self._sdeltas[:s_b].copy()
        sgaps[s_n:] = 0   # zero-gap zero-add pads: no-ops wherever they land
        sdeltas[s_n:] = 0
        stats = {
            "transport": "packed", "frames": n, "nnz": e_n,
            "bytes_shipped": 2 * e_b + 3 * s_b + qtables.nbytes,
            "bytes_dense": n * blocks * 128 + qtables.nbytes,
        }
        self.last_stats = stats
        return HostPacked(gaps, vals, sgaps, sdeltas, qtables, h, w,
                          (bh, bw), stats)

    def decode_split(self, jpegs: list[bytes],
                     zmax: int = 64) -> jnp.ndarray:
        """Decode a batch to ``(B, H, W)`` float32 via the SPLIT (DC/AC
        separated) transport — identical output to :meth:`decode` at the
        default ``zmax=64``, the fewest host->device bytes of the three
        transports (~40% below PACKED on real q70 streams: the measured
        byte split is ~25% block DCs with large values that need no gaps,
        ~75% ACs with small gaps and small values that fit one byte).

        ``zmax`` < 64 selects the detect-grade band-limited profile (module
        header): identical to the dense decode with zigzag indices >= zmax
        zeroed, at a further large byte cut."""
        return self.split_to_device(self.entropy_decode_split(jpegs, zmax))

    def split_to_device(self, hs: HostSplit) -> jnp.ndarray:
        """Device half of :meth:`decode_split` — jit dispatch, MAIN thread
        only (see HostPacked)."""
        self.last_stats = hs.stats
        return split_idct_frames(
            jnp.asarray(hs.ac), jnp.asarray(hs.dc), jnp.asarray(hs.sgaps),
            jnp.asarray(hs.sdeltas), jnp.asarray(hs.dgaps),
            jnp.asarray(hs.ddeltas), jnp.asarray(hs.qtables),
            height=hs.height, width=hs.width, grid=hs.grid, zmax=hs.zmax)

    def entropy_decode_split(self, jpegs: list[bytes],
                             zmax: int = 64) -> HostSplit:
        """Host half of :meth:`decode_split` — pure numpy + native call,
        safe on a prefetch thread (no jax dispatch)."""
        import ctypes
        if not 2 <= zmax <= 64:
            raise ValueError(f"zmax must be in [2, 64], got {zmax}")
        ns = zmax - 1
        self._ensure_meta(jpegs[0])
        n = len(jpegs)
        args = None
        for attempt in range(2):
            w, h, bw, bh = self._meta
            blocks = bw * bh
            # int32 position-space guard (see entropy_decode_packed): the
            # AC space is zmax-1 slots/block, the DC space `blocks` slots.
            if n * blocks * ns >= 2 ** 31:
                raise ValueError(
                    f"split transport: batch of {n} frames x {blocks} "
                    f"blocks exceeds the int32 position space; split the "
                    f"batch")
            if args is None:
                args = self._batch_args(jpegs)
            if self._accap == 0:
                # ~4 AC bytes/block measured on q70 480p; grow on demand.
                self._accap = 5 * blocks * n
                self._ascap = max(blocks * n // 16, 1 << 12)
                self._dscap = max(blocks * n // 64, 1 << 12)
            meta = (ctypes.c_int32 * 4)()
            qtables = np.empty((n, 64), np.uint16)
            counts = np.zeros(3, np.int64)
            bpf2 = (blocks + 2) // 2  # nibble lane: flag + blocks nibbles
            if self._dc is None or self._dc.size < n * bpf2:
                self._dc = np.empty(n * bpf2, np.uint8)
            while True:
                if self._ac is None or self._ac.size < self._accap:
                    self._ac = np.empty(self._accap, np.uint8)
                if self._asg is None or self._asg.size < self._ascap:
                    self._asg = np.empty(self._ascap, np.uint16)
                    self._asd = np.empty(self._ascap, np.int16)
                if self._dsg is None or self._dsg.size < self._dscap:
                    self._dsg = np.empty(self._dscap, np.uint16)
                    self._dsd = np.empty(self._dscap, np.int16)
                call_args = (
                    *args,
                    self._ac.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    self._accap,
                    self._dc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    self._asg.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint16)),
                    self._asd.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                    self._ascap,
                    self._dsg.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint16)),
                    self._dsd.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                    self._dscap,
                    counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    blocks, meta,
                    qtables.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                    zmax)
                if self._workers > 1:
                    got = self._lib.vbs_mjpeg_batch_y_coeffs_split_mt(
                        *call_args, self._workers)
                else:
                    got = self._lib.vbs_mjpeg_batch_y_coeffs_split(*call_args)
                if got == n:
                    break
                if got == _RC_AC_CAP:
                    # Hard ceiling: 63 all-EXT entries (2 B) + fillers per
                    # block can approach ~128 B/block on adversarial input.
                    self._accap = min(2 * self._accap, 140 * blocks * n)
                elif got == _RC_AC_SPILL_CAP:
                    self._ascap = min(2 * self._ascap, 64 * blocks * n)
                elif got == _RC_DC_SPILL_CAP:
                    self._dscap = min(2 * self._dscap, 2 * blocks * n)
                else:
                    break
            if got == n and (meta[0], meta[1], meta[2],
                             meta[3]) == self._meta:
                break
            if attempt > 0:
                raise ValueError(f"JPEG batch decode failed at frame {got}")
            self._relearn_or_raise(jpegs, got, n)
        a_n, s_n, d_n = int(counts[0]), int(counts[1]), int(counts[2])
        a_b = min(_bucket(a_n), self._ac.size)
        s_b = min(_bucket(s_n), self._asg.size)
        d_b = min(_bucket(d_n), self._dsg.size)
        # Tail padding overrun guard (see entropy_decode_packed): AC pad
        # bytes are 0x87 escapes advancing 8 blocks each. Spill pads are
        # (gap=0, delta=0) zero-adds and can't overrun (65535-gap pads
        # overflowed int32 on spill-heavy q70+ streams — a real stream
        # class, not an adversarial one).
        if n * blocks * ns + 8 * ns * (a_b - a_n) >= 2 ** 31:
            raise ValueError(
                "split transport: tail-pad positions would exceed the "
                "int32 position space; split the batch")
        ac = self._ac[:a_b].copy()
        ac[a_n:] = 0x87  # escape x 8 blocks: positions overrun and drop
        dc = self._dc[:n * ((blocks + 2) // 2)].copy()
        sgaps = self._asg[:s_b].copy()
        sdeltas = self._asd[:s_b].copy()
        sgaps[s_n:] = 0
        sdeltas[s_n:] = 0
        dgaps = self._dsg[:d_b].copy()
        ddeltas = self._dsd[:d_b].copy()
        dgaps[d_n:] = 0
        ddeltas[d_n:] = 0
        stats = {
            "transport": "split", "frames": n, "nnz": a_n, "zmax": zmax,
            "bytes_shipped": (a_b + n * ((blocks + 2) // 2) + 4 * s_b
                              + 4 * d_b + qtables.nbytes),
            "bytes_dense": n * blocks * 128 + qtables.nbytes,
        }
        self.last_stats = stats
        return HostSplit(ac, dc, sgaps, sdeltas, dgaps, ddeltas, qtables,
                         h, w, (bh, bw), stats, zmax)

    def decode_tdelta(self, jpegs: list[bytes],
                      zmax: int = 64) -> jnp.ndarray:
        """Decode a batch to ``(B, H, W)`` float32 via the TDELTA
        (temporal-delta) transport — identical output to :meth:`decode` at
        ``zmax=64``. On the production workload (a static camera watching
        a slowly-deforming gel) ~96% of blocks are bit-identical frame to
        frame, so shipping per-block coefficient DELTAS cuts the exact
        link bytes ~8x below SPLIT (module header); adversarial (noise)
        streams degrade boundedly to ~2x SPLIT's entry count."""
        return self.tdelta_to_device(self.entropy_decode_tdelta(jpegs, zmax))

    def tdelta_to_device(self, ht: HostTDelta) -> jnp.ndarray:
        """Device half of :meth:`decode_tdelta` — jit dispatch, MAIN thread
        only (see HostPacked)."""
        self.last_stats = ht.stats
        return tdelta_idct_frames(
            jnp.asarray(ht.ac), jnp.asarray(ht.sgaps),
            jnp.asarray(ht.sdeltas), jnp.asarray(ht.qtables),
            height=ht.height, width=ht.width, grid=ht.grid, zmax=ht.zmax)

    def entropy_decode_tdelta(self, jpegs: list[bytes],
                              zmax: int = 64) -> HostTDelta:
        """Host half of :meth:`decode_tdelta` — pure numpy + native call,
        safe on a prefetch thread (no jax dispatch). Every batch is
        self-contained (its first frame deltas against all-zeros)."""
        import ctypes
        if not 2 <= zmax <= 64:
            raise ValueError(f"zmax must be in [2, 64], got {zmax}")
        ns = zmax
        self._ensure_meta(jpegs[0])
        n = len(jpegs)
        args = None
        for attempt in range(2):
            w, h, bw, bh = self._meta
            blocks = bw * bh
            # int32 position-space guard (see entropy_decode_packed).
            if n * blocks * ns >= 2 ** 31:
                raise ValueError(
                    f"tdelta transport: batch of {n} frames x {blocks} "
                    f"blocks exceeds the int32 position space; split the "
                    f"batch")
            if args is None:
                args = self._batch_args(jpegs)
            if self._tcap == 0:
                # Replenishment streams are tiny in steady state but the
                # first frame ships absolute (~1 byte/nonzero); size for
                # that and grow on demand.
                self._tcap = max(2 * blocks * n, 1 << 16)
                self._tscap = max(blocks * n // 64, 1 << 12)
            meta = (ctypes.c_int32 * 4)()
            qtables = np.empty((n, 64), np.uint16)
            counts = np.zeros(2, np.int64)
            while True:
                if self._tac is None or self._tac.size < self._tcap:
                    self._tac = np.empty(self._tcap, np.uint8)
                if self._tsg is None or self._tsg.size < self._tscap:
                    self._tsg = np.empty(self._tscap, np.uint16)
                    self._tsd = np.empty(self._tscap, np.int16)
                call_args = (
                    *args,
                    self._tac.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    self._tcap,
                    self._tsg.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint16)),
                    self._tsd.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                    self._tscap,
                    counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    blocks, meta,
                    qtables.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                    zmax)
                if self._workers > 1:
                    got = self._lib.vbs_mjpeg_batch_y_coeffs_tdelta_mt(
                        *call_args, self._workers)
                else:
                    got = self._lib.vbs_mjpeg_batch_y_coeffs_tdelta(
                        *call_args)
                if got == n:
                    break
                if got == _RC_AC_CAP:
                    # Hard ceiling: the delta support is at most
                    # nnz(cur) + nnz(prev) entries of <= 2 bytes + escapes.
                    self._tcap = min(2 * self._tcap, 280 * blocks * n)
                elif got == _RC_AC_SPILL_CAP:
                    self._tscap = min(2 * self._tscap, 128 * blocks * n)
                else:
                    break
            if got == n and (meta[0], meta[1], meta[2],
                             meta[3]) == self._meta:
                break
            if attempt > 0:
                raise ValueError(f"JPEG batch decode failed at frame {got}")
            self._relearn_or_raise(jpegs, got, n)
        a_n, s_n = int(counts[0]), int(counts[1])
        a_b = min(_bucket(a_n), self._tac.size)
        s_b = min(_bucket(s_n), self._tsg.size)
        # Tail-pad overrun guard (see entropy_decode_packed): pads are
        # 0x86 one-byte escapes advancing 7 blocks each.
        if n * blocks * ns + 7 * ns * (a_b - a_n) >= 2 ** 31:
            raise ValueError(
                "tdelta transport: tail-pad positions would exceed the "
                "int32 position space; split the batch")
        ac = self._tac[:a_b].copy()
        ac[a_n:] = 0x86  # escape, 7 blocks: positions overrun and drop
        sgaps = self._tsg[:s_b].copy()
        sdeltas = self._tsd[:s_b].copy()
        sgaps[s_n:] = 0
        sdeltas[s_n:] = 0
        stats = {
            "transport": "tdelta", "frames": n, "nnz": a_n, "zmax": zmax,
            "bytes_shipped": a_b + 4 * s_b + qtables.nbytes,
            "bytes_dense": n * blocks * 128 + qtables.nbytes,
        }
        self.last_stats = stats
        return HostTDelta(ac, sgaps, sdeltas, qtables, h, w, (bh, bw),
                          stats, zmax)
