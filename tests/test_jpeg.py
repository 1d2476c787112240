"""Device JPEG decode path: native entropy decoder + device IDCT vs libjpeg."""
import numpy as np
import pytest

import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")


def _lib_or_skip():
    from vision_basedsensor_tpu.native import load_jpeg_lib
    lib = load_jpeg_lib()
    if lib is None:
        pytest.skip("no C++ compiler available for the native JPEG decoder")
    return lib


def _textured(h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = (np.add.outer(np.sin(np.arange(h) / 13.0),
                        np.cos(np.arange(w) / 29.0)) * 55 + 120)
    img += rng.normal(0, 9, (h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("quality", [50, 70, 95])
@pytest.mark.parametrize("shape", [(480, 640), (240, 320), (41, 67)])
def test_decode_matches_libjpeg(quality, shape):
    """Dequant+IDCT on device must match libjpeg's full decode to IDCT
    rounding (libjpeg uses an integer IDCT; ours is the exact float one)."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    img = _textured(*shape)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    ref = cv2.imdecode(enc, cv2.IMREAD_GRAYSCALE).astype(np.float32)

    out = np.asarray(MjpegBatchDecoder().decode([enc.tobytes()]))[0]
    assert out.shape == ref.shape
    d = np.abs(out - ref)
    assert d.max() <= 2.0, d.max()
    assert d.mean() < 0.2, d.mean()


def test_decode_color_jpeg_luma(tmp_path):
    """3-component 4:2:0 JPEGs (what the capture server streams): the
    decoder must skip chroma correctly and return the Y channel."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    gray = _textured(120, 160, seed=3)
    color = cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)
    ok, enc = cv2.imencode(".jpg", color, [cv2.IMWRITE_JPEG_QUALITY, 70])
    ref = cv2.imdecode(enc, cv2.IMREAD_GRAYSCALE).astype(np.float32)
    out = np.asarray(MjpegBatchDecoder().decode([enc.tobytes()]))[0]
    assert np.abs(out - ref).max() <= 2.0


@pytest.mark.parametrize("method", ["decode", "decode_packed",
                                    "decode_split", "decode_tdelta"])
def test_restart_markers(method):
    """DRI/RSTn streams (some cameras emit them) decode correctly through
    every transport — restarts reset the DC prediction mid-scan, which the
    split transport's own per-frame DC delta chain must reproduce."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    img = _textured(64, 96, seed=5)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 80,
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    jpeg = enc.tobytes()
    assert b"\xff\xdd" in jpeg[:1000]  # DRI present
    ref = cv2.imdecode(enc, cv2.IMREAD_GRAYSCALE).astype(np.float32)
    out = np.asarray(getattr(MjpegBatchDecoder(), method)([jpeg]))[0]
    assert np.abs(out - ref).max() <= 2.0


def test_device_avi_source_matches_host_source(tmp_path):
    """MjpegAviDeviceSource frames == MjpegAviSource frames within IDCT
    rounding, and the detector sees identical markers through both."""
    _lib_or_skip()
    from vision_basedsensor_tpu.config import DetectConfig
    from vision_basedsensor_tpu.detect import detect_markers
    from vision_basedsensor_tpu.io.video import (
        MjpegAviSource, MjpegAviDeviceSource, VideoWriter)
    from vision_basedsensor_tpu.synth import default_scene, render_frames

    scene = default_scene(height=240, width=320)
    d = jnp.zeros((4, 65, 3), jnp.float32)
    d = d.at[:, :, 2].add(-0.4 * jnp.arange(4)[:, None])
    frames = np.asarray(render_frames(scene, d)).astype(np.uint8)
    path = str(tmp_path / "clip.avi")
    vw = VideoWriter(path, 12.0, (320, 240), fourcc="MJPG")
    for f in frames:
        vw.write(f)
    vw.close()

    host = np.concatenate(list(MjpegAviSource(path, gray=True).batches(2)))
    dev = np.concatenate([np.asarray(b)
                          for b in MjpegAviDeviceSource(path).batches(2)])
    assert dev.shape == host.shape == (4, 240, 320)
    assert np.abs(dev - host.astype(np.float32)).max() <= 2.0

    det_h = detect_markers(jnp.asarray(host.astype(np.float32)), DetectConfig())
    det_t = detect_markers(jnp.asarray(dev), DetectConfig())
    vh, vt = np.asarray(det_h.valid), np.asarray(det_t.valid)
    assert (vh.sum(1) == vt.sum(1)).all()
    for t in range(4):
        for p in np.asarray(det_h.xy)[t][vh[t]]:
            assert np.linalg.norm(np.asarray(det_t.xy)[t][vt[t]] - p,
                                  axis=1).min() < 0.1


@pytest.mark.parametrize("quality", [50, 70, 95])
@pytest.mark.parametrize("shape", [(480, 640), (41, 67)])
def test_packed_transport_matches_dense(quality, shape):
    """The sparse (packed) transport must reproduce the dense path BITWISE:
    same coefficients in, same IDCT math, so identical float frames out."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    jpegs = []
    for seed in range(3):
        img = _textured(*shape, seed=seed)
        ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
        assert ok
        jpegs.append(enc.tobytes())
    dec = MjpegBatchDecoder()
    dense = np.asarray(dec.decode(jpegs))
    packed = np.asarray(dec.decode_packed(jpegs))
    assert (dense == packed).all()
    stats = dec.last_stats
    assert stats["transport"] == "packed"
    # The sparse transport must actually be smaller than dense (the whole
    # point of the format) at stream-typical qualities. At q95 the noisy
    # test texture keeps nearly every coefficient, where packed degrades
    # gracefully to dense + ~7% structure overhead — correctness above
    # still holds, the byte win does not.
    if quality <= 70:
        assert stats["bytes_shipped"] < stats["bytes_dense"]


@pytest.mark.parametrize("method", ["decode_packed", "decode_split",
                                    "decode_tdelta"])
def test_sparse_transport_color_420(method):
    """4:2:0 color JPEGs exercise the MCU-row staging (two block rows per
    MCU row must be re-emitted in flat row-major order) — for the split
    transport that order is also what keeps its DC delta chain and zigzag
    AC positions strictly increasing."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    gray = _textured(120, 160, seed=7)
    color = cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)
    ok, enc = cv2.imencode(".jpg", color, [cv2.IMWRITE_JPEG_QUALITY, 70])
    ref = cv2.imdecode(enc, cv2.IMREAD_GRAYSCALE).astype(np.float32)
    dec = MjpegBatchDecoder()
    out = np.asarray(getattr(dec, method)([enc.tobytes()]))[0]
    assert np.abs(out - ref).max() <= 2.0


def test_packed_capacity_growth():
    """Undersized packed streams must grow on the specific capacity rc and
    converge — not loop or misdecode."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    img = _textured(64, 96, seed=9)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    dec = MjpegBatchDecoder()
    ref = np.asarray(dec.decode([enc.tobytes()]))
    dec._cap, dec._scap = 8, 8  # force both growth paths (entries + spill)
    out = np.asarray(dec.decode_packed([enc.tobytes()]))
    assert (out == ref).all()


def test_packed_malformed_raises():
    """A malformed JPEG must raise immediately — no growth retries."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    img = _textured(32, 32)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 70])
    dec = MjpegBatchDecoder()
    dec.decode_packed([enc.tobytes()])  # learn geometry
    bad = enc.tobytes()[:40]  # truncated mid-header
    with pytest.raises(ValueError):
        dec.decode_packed([bad, enc.tobytes()])


def test_geometry_change_between_batches_reprobes():
    """Review finding (round 3): the decoder cached geometry forever, so a
    stream whose camera reconfigures resolution mid-session kept reshaping
    NEW coefficients with STALE geometry — valid-shaped garbage frames
    (measured max error ~180 gray levels) that no downstream shape guard
    could catch. The per-batch SOF sniff must re-probe instead, for both
    transports and in both directions (shrink and grow)."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder

    imgs = {s: _textured(*s, seed=hash(s) % 100) for s in
            [(64, 96), (32, 48), (128, 160)]}
    encs = {}
    refs = {}
    for s, img in imgs.items():
        ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 70])
        assert ok
        encs[s] = enc.tobytes()
        refs[s] = cv2.imdecode(enc, cv2.IMREAD_GRAYSCALE).astype(np.float32)

    for method in ("decode", "decode_packed", "decode_split"):
        dec = MjpegBatchDecoder()
        for s in [(64, 96), (32, 48), (128, 160), (64, 96)]:
            out = np.asarray(getattr(dec, method)([encs[s]]))[0]
            assert out.shape == s, (method, s, out.shape)
            assert np.abs(out - refs[s]).max() <= 2.0, (method, s)


def test_packed_transport_rejects_int32_position_overflow():
    """The device-side position cumsum is int32; a batch whose flat
    coefficient space exceeds 2^31 must fail loudly, not silently drop
    scattered coefficients."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder

    img = _textured(1088, 1920)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 70])
    assert ok
    dec = MjpegBatchDecoder()
    dec._probe(enc.tobytes())
    w, h, bw, bh = dec._meta
    n_over = 2 ** 31 // (bw * bh * 64) + 1
    with pytest.raises(ValueError, match="int32 position space"):
        # The guard fires BEFORE the payload join / native decode (a clean
        # rejection must not first concatenate hundreds of MB on the weak
        # hosts this path targets), so duplicating the reference is cheap.
        dec.decode_packed([enc.tobytes()] * n_over)


def test_progressive_jpeg_rejected_cleanly():
    """The native decoder is baseline-only; a progressive (SOF2) stream —
    some IP cameras emit these — must fail with a clear parse error on
    both transports, never return garbage frames."""
    _lib_or_skip()
    import io

    from PIL import Image

    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder

    img = _textured(64, 96)
    b = io.BytesIO()
    Image.fromarray(img).save(b, format="JPEG", progressive=True, quality=70)
    j = b.getvalue()
    for method in ("decode", "decode_packed", "decode_split"):
        with pytest.raises(ValueError, match="JPEG parse failed"):
            getattr(MjpegBatchDecoder(), method)([j])


def test_native_decoder_survives_malformed_bytes():
    """The native parser consumes untrusted network bytes (MJPEG streams):
    mutated/truncated/garbage-injected JPEGs must either decode or raise a
    clean ValueError — never crash the process. (A 3000-mutation fuzz run
    passed during round 3; this keeps a 400-case smoke in CI.)"""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder

    rng = np.random.default_rng(0)
    img = (rng.random((64, 96)) * 255).astype(np.uint8)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 70])
    assert ok
    base = bytearray(enc.tobytes())
    dec = MjpegBatchDecoder()
    for trial in range(400):
        j = bytearray(base)
        kind = trial % 4
        if kind == 0:
            j[rng.integers(0, len(j))] ^= 1 << rng.integers(0, 8)
        elif kind == 1:
            j = j[:rng.integers(4, len(j))]
        elif kind == 2:
            for _ in range(8):
                j[rng.integers(0, len(j))] = rng.integers(0, 256)
        else:
            pos = int(rng.integers(2, len(j)))
            j = (j[:pos] + bytes(rng.integers(0, 256, 32, dtype=np.uint8))
                 + j[pos:])
        try:
            # Alternate transports: split's sink (DC chain + escapes +
            # three capacity paths) is its own attack surface.
            if trial % 2:
                np.asarray(dec.decode_split([bytes(j)]))
            else:
                np.asarray(dec.decode_packed([bytes(j)]))
        except ValueError:
            pass


def test_chroma_subsampling_switch_mid_stream():
    """Review finding (round 3, second pass): a chroma-subsampling switch
    at UNCHANGED pixel dims changes the luma block grid when w % 16 != 0
    (4:4:4 -> 13x7 vs 4:2:0 -> 14x8 at 100x56) — invisible to the SOF
    dimension sniff. The decoder must detect it from the native call's
    returned meta and retry with fresh geometry, both directions."""
    _lib_or_skip()
    import io

    from PIL import Image

    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder

    h, w = 56, 100
    rgb = (np.random.default_rng(0).random((h, w, 3)) * 255).astype(np.uint8)
    jp, ref = {}, {}
    for sub in (0, 2):
        b = io.BytesIO()
        Image.fromarray(rgb).save(b, format="JPEG", quality=70,
                                  subsampling=sub)
        jp[sub] = b.getvalue()
        ref[sub] = cv2.imdecode(np.frombuffer(jp[sub], np.uint8),
                                cv2.IMREAD_GRAYSCALE).astype(np.float32)

    for method in ("decode", "decode_packed"):
        dec = MjpegBatchDecoder()
        grids = []
        for sub in (0, 2, 0):
            out = np.asarray(getattr(dec, method)([jp[sub]]))[0]
            grids.append(dec._meta[2:])
            assert out.shape == (h, w)
            assert np.abs(out - ref[sub]).max() <= 2.0, (method, sub)
        assert grids[0] != grids[1]        # the grids genuinely differ


def test_single_component_jpeg_with_subsampled_factors():
    """A one-component JPEG is NON-interleaved per the spec (A.2.2) even
    when its SOF declares 2x2 sampling factors — PIL emits exactly that
    for grayscale images saved with subsampling=2; honoring the factors
    produced a 2x2-MCU misparse (garbage frames, native fix round 3)."""
    _lib_or_skip()
    import io

    from PIL import Image

    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder

    img = _textured(56, 100)
    b = io.BytesIO()
    Image.fromarray(img).save(b, format="JPEG", quality=70, subsampling=2)
    j = b.getvalue()
    dec = MjpegBatchDecoder()
    out = np.asarray(dec.decode_packed([j]))[0]
    assert dec._meta[2:] == (13, 7)        # ceil(100/8) x ceil(56/8)
    ref = np.asarray(Image.open(io.BytesIO(j))).astype(np.float32)
    assert np.abs(out - ref).max() <= 2.0


def test_malicious_headers_rejected():
    """Security review (round 3): three header-validation holes let pure
    header bytes drive stack OOB accesses — an over-subscribed (non-Kraft)
    DHT smashed the Huffman LUT fill (attacker-controlled stack WRITE), an
    out-of-range SOF quant-table selector read+leaked stack memory, and
    unchecked SOS table selectors indexed past the 4-element Huff arrays.
    Each must now fail with a clean parse error."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder

    img = _textured(32, 32)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 70])
    base = enc.tobytes()

    def corrupt(marker, offset, value):
        i = base.index(marker)
        b = bytearray(base)
        b[i + offset] = value
        return bytes(b)

    # Over-subscribed DHT: 4 codes of length 1 (max 2 fit).
    i = base.index(b"\xff\xc4")
    dht = bytearray(base)
    dht[i + 5] = 4                       # counts[0] (L1) = 4
    # SOF0 tq selector out of range (payload: len2 prec1 h2 w2 ncomp1
    # id1 hv1 tq1 -> tq at marker+12).
    sof_tq = corrupt(b"\xff\xc0", 2 + 10, 0xFF)
    # SOS Td/Ta selectors out of range (byte after comp id).
    sos = corrupt(b"\xff\xda", 2 + 4, 0xFF)

    for name, j in [("dht", bytes(dht)), ("sof_tq", sof_tq), ("sos", sos)]:
        with pytest.raises(ValueError, match="JPEG"):
            MjpegBatchDecoder().decode_packed([j])

@pytest.mark.parametrize("workers", [2, 3, 7])
def test_multithreaded_delta_matches_serial(workers):
    """The MT packed decode must reproduce the serial stream's SEMANTICS:
    identical dense coefficients after expansion (filler placement at slice
    joins may differ), hence bitwise-identical frames. Includes a uniform
    frame (zero entries — exercises empty-slice bridging) and a
    high-contrast frame (spill-stream entries)."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    jpegs = []
    for seed in range(9):
        if seed == 3:
            img = np.full((120, 160), 128, np.uint8)  # all-zero coefficients
        elif seed == 5:
            img = (_textured(120, 160, seed=seed) > 127).astype(np.uint8) * 255
        else:
            img = _textured(120, 160, seed=seed)
        ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 70])
        assert ok
        jpegs.append(enc.tobytes())

    serial = np.asarray(MjpegBatchDecoder(workers=1).decode_packed(jpegs))
    mt = np.asarray(MjpegBatchDecoder(workers=workers).decode_packed(jpegs))
    assert (serial == mt).all()


def test_multithreaded_delta_error_protocol():
    """MT failure protocol matches serial: the index of the first bad frame."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    good = [cv2.imencode(".jpg", _textured(120, 160, seed=s),
                         [cv2.IMWRITE_JPEG_QUALITY, 70])[1].tobytes()
            for s in range(6)]
    bad = good[4][:40]  # truncated mid-header
    dec = MjpegBatchDecoder(workers=3)
    dec.decode_packed(good)  # learn geometry
    with pytest.raises(ValueError, match="frame 4"):
        dec.decode_packed(good[:4] + [bad] + good[5:])


@pytest.mark.parametrize("quality", [20, 70, 95])
@pytest.mark.parametrize("shape", [(480, 640), (41, 67)])
def test_split_transport_matches_dense(quality, shape):
    """The SPLIT (DC/AC separated) transport must reproduce the dense path
    BITWISE — same coefficients in, same IDCT math — including frames with
    no ACs at all (uniform: pure escape/DC traffic), hard edges (AC values
    past the 5-bit clamp -> spill stream), and big DC jumps (DC deltas past
    int8 -> DC spill stream)."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    imgs = [_textured(*shape, seed=s) for s in range(3)]
    imgs.append(np.full(shape, 128, np.uint8))                 # no ACs
    imgs.append((_textured(*shape, seed=7) > 127).astype(np.uint8) * 255)
    checker = np.zeros(shape, np.uint8)                        # DC spills
    checker[::16] = 255
    checker[:, ::16] = 250
    imgs.append(checker)
    jpegs = []
    for img in imgs:
        ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY,
                                             quality])
        assert ok
        jpegs.append(enc.tobytes())
    dec = MjpegBatchDecoder()
    dense = np.asarray(dec.decode(jpegs))
    split = np.asarray(dec.decode_split(jpegs))
    assert (dense == split).all()
    stats = dec.last_stats
    assert stats["transport"] == "split"
    # The split format must beat the 2-byte delta pairs at stream-typical
    # qualities (the whole point: ~1 byte/AC + 1 byte/block).
    if quality <= 70 and shape == (480, 640):
        packed = dec.entropy_decode_packed(jpegs).stats
        assert stats["bytes_shipped"] < packed["bytes_shipped"]


def test_split_capacity_growth():
    """Undersized split streams must grow on their specific capacity rcs
    (AC bytes, AC spill, DC spill) and converge — not loop or misdecode."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    img = _textured(64, 96, seed=9)
    img[::8] = 255  # DC jumps at every block row -> DC spill traffic
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    dec = MjpegBatchDecoder()
    ref = np.asarray(dec.decode([enc.tobytes()]))
    dec._accap, dec._ascap, dec._dscap = 8, 8, 8
    out = np.asarray(dec.decode_split([enc.tobytes()]))
    assert (out == ref).all()


def test_split_error_protocol():
    """Split failure protocol matches the others: the index of the first
    bad frame, no growth retries on malformed bytes."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    good = [cv2.imencode(".jpg", _textured(120, 160, seed=s),
                         [cv2.IMWRITE_JPEG_QUALITY, 70])[1].tobytes()
            for s in range(4)]
    dec = MjpegBatchDecoder()
    dec.decode_split(good)  # learn geometry
    with pytest.raises(ValueError, match="frame 2"):
        dec.decode_split(good[:2] + [good[3][:40]] + good[3:])


@pytest.mark.parametrize("workers", [2, 3, 7])
def test_multithreaded_split_matches_serial(workers):
    """The MT split decode must reproduce the serial stream's SEMANTICS:
    identical dense coefficients after expansion (bridge-byte placement at
    slice joins may differ), hence bitwise-identical frames. Includes a
    uniform frame (no ACs — exercises empty-slice bridging over whole
    frames) and a high-contrast frame (AC + DC spill traffic)."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    jpegs = []
    for seed in range(9):
        if seed == 3:
            img = np.full((120, 160), 128, np.uint8)
        elif seed == 5:
            img = (_textured(120, 160, seed=seed) > 127).astype(np.uint8) * 255
        else:
            img = _textured(120, 160, seed=seed)
        ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 70])
        assert ok
        jpegs.append(enc.tobytes())

    serial = np.asarray(MjpegBatchDecoder(workers=1).decode_split(jpegs))
    mt = np.asarray(MjpegBatchDecoder(workers=workers).decode_split(jpegs))
    assert (serial == mt).all()


def test_multithreaded_split_error_protocol():
    """MT split failure protocol matches serial: index of first bad frame."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    good = [cv2.imencode(".jpg", _textured(120, 160, seed=s),
                         [cv2.IMWRITE_JPEG_QUALITY, 70])[1].tobytes()
            for s in range(6)]
    dec = MjpegBatchDecoder(workers=3)
    dec.decode_split(good)  # learn geometry
    with pytest.raises(ValueError, match="frame 4"):
        dec.decode_split(good[:4] + [good[4][:40]] + good[5:])


def test_split_vlc_ext_values_exact():
    """The 1/2-byte VLC framing: values outside the 5-bit short range
    ([-14, 15]) ride EXT pairs; |v| > 127 still spills. Frames built to
    hit every class (tiny values, 16..127 band, extreme edges) must
    reproduce the dense path bitwise."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    shape = (96, 128)
    imgs = [np.full(shape, 100, np.uint8),
            _textured(*shape, seed=1),
            (_textured(*shape, seed=2) > 127).astype(np.uint8) * 255]
    # A one-pixel impulse per block center maximizes per-block AC spread.
    imp = np.full(shape, 64, np.uint8)
    imp[4::8, 4::8] = 255
    imgs.append(imp)
    jpegs = [cv2.imencode(".jpg", i, [cv2.IMWRITE_JPEG_QUALITY, q])[1]
             .tobytes() for i in imgs for q in (20, 95)]
    dec = MjpegBatchDecoder()
    dense = np.asarray(dec.decode(jpegs))
    split = np.asarray(dec.decode_split(jpegs))
    assert (dense == split).all()


def test_split_all_uniform_batch():
    """A batch with NO AC entries and NO spills at all: every spill stream
    is pure (gap=0, delta=0) tail padding, whose cumsum lands at -1 —
    the zero-adds must be no-ops (a negative index wraps to the last
    element) and the frames must still match dense. Regression for the
    round-4 padding scheme whose 65535-gap pads overflowed the int32
    position guard on spill-heavy real streams."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    jpegs = [cv2.imencode(".jpg", np.full((64, 96), v, np.uint8),
                          [cv2.IMWRITE_JPEG_QUALITY, 70])[1].tobytes()
             for v in (128, 129, 130)]
    dec = MjpegBatchDecoder()
    dense = np.asarray(dec.decode(jpegs))
    split = np.asarray(dec.decode_split(jpegs))
    assert (dense == split).all()


def test_split_dc_adaptive_prediction():
    """The DC lane's per-frame flag must pick TEMPORAL on a slow-moving
    sequence (deltas ~0) and SPATIAL on a scene cut (temporal deltas
    explode) — and decode exactly either way. Frame 0 is always spatial
    (no temporal predictor exists)."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    base = _textured(96, 128, seed=4)
    rng = np.random.default_rng(0)
    frames = [base]
    for _ in range(3):  # slow drift
        frames.append(np.clip(frames[-1].astype(np.int16)
                              + rng.integers(-1, 2, base.shape), 0,
                              255).astype(np.uint8))
    frames.append(255 - base)  # scene cut
    jpegs = [cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, 70])[1]
             .tobytes() for f in frames]
    dec = MjpegBatchDecoder()
    dense = np.asarray(dec.decode(jpegs))
    hs = dec.entropy_decode_split(jpegs)
    assert (np.asarray(dec.split_to_device(hs)) == dense).all()
    blocks = hs.grid[0] * hs.grid[1]
    bpf2 = (blocks + 2) // 2
    flags = hs.dc[np.arange(len(frames)) * bpf2] & 1
    assert flags[0] == 0                    # spatial: nothing to predict from
    assert flags[1:4].sum() == 3            # slow drift -> temporal
    assert flags[4] == 0                    # scene cut -> spatial wins


@pytest.mark.parametrize("zmax", [2, 6, 15, 22])
def test_split_band_limit_matches_zeroed_dense(zmax):
    """The zmax band limit must equal the dense decode with zigzag scan
    indices >= zmax zeroed — EXACTLY (the shrunken IDCT basis is the same
    linear map as zero-padding the dropped coefficients)."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import (MjpegBatchDecoder,
                                                 idct_frames, _ZIGZAG)
    jpegs = [cv2.imencode(".jpg", _textured(96, 128, seed=s),
                          [cv2.IMWRITE_JPEG_QUALITY, q])[1].tobytes()
             for s, q in ((0, 70), (1, 95), (2, 30))]
    dec = MjpegBatchDecoder()
    hd = dec.entropy_decode_dense(jpegs)
    out = np.asarray(dec.decode_split(jpegs, zmax=zmax))
    co = hd.coeffs.copy()
    rank = np.empty(64, np.int64)
    rank[_ZIGZAG] = np.arange(64)
    co.reshape(-1, 64)[:, rank >= zmax] = 0
    ref = np.asarray(idct_frames(jnp.asarray(co), jnp.asarray(hd.qtables),
                                 height=hd.height, width=hd.width))
    assert (out == ref).all()


@pytest.mark.parametrize("workers", [2, 5])
def test_multithreaded_split_band_limit_matches_serial(workers):
    """MT + zmax: slice bridging runs in the shrunken position space."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    jpegs = [cv2.imencode(".jpg", _textured(120, 160, seed=s),
                          [cv2.IMWRITE_JPEG_QUALITY, 70])[1].tobytes()
             for s in range(9)]
    serial = np.asarray(
        MjpegBatchDecoder(workers=1).decode_split(jpegs, zmax=10))
    mt = np.asarray(
        MjpegBatchDecoder(workers=workers).decode_split(jpegs, zmax=10))
    assert (serial == mt).all()


@pytest.mark.slow
def test_split_band_limit_detect_envelope():
    """End-to-end accuracy contract of the DETECT-GRADE band limit on a
    rendered q70 sensor stream: every marker must still detect and match
    within the association gate, centroids within ~1.5 px of the exact
    decode (the q70 floor itself measures ~0.4 px p99) — while photometric
    AXES may drift several px (measured p99 ~5.8 at zmax=15), which is why
    the band limit is an opt-in tracking-grade profile, NOT the default:
    diameters feed depth reconstruction (ops/jpeg.py module header)."""
    _lib_or_skip()
    import jax

    from vision_basedsensor_tpu.config import PipelineConfig
    from vision_basedsensor_tpu.detect.detector import detect_markers
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    from vision_basedsensor_tpu.synth import default_scene, render_frames

    scene = default_scene(height=480, width=640)
    d = jnp.zeros((2, 65, 3), jnp.float32)
    d = d.at[:, :, 2].add(-0.02 * jnp.arange(2)[:, None])
    frames = np.asarray(jax.block_until_ready(
        render_frames(scene, d))).astype(np.uint8)
    jpegs = [cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, 70])[1]
             .tobytes() for f in frames]
    dec = MjpegBatchDecoder()
    cfg = PipelineConfig()
    base = jax.tree.map(np.asarray,
                        detect_markers(dec.decode_split(jpegs), cfg.detect))
    z15 = jax.tree.map(np.asarray, detect_markers(
        dec.decode_split(jpegs, zmax=15), cfg.detect))
    for b in range(2):
        vb = base.valid[b].astype(bool)
        vz = z15.valid[b].astype(bool)
        pb, pz = base.xy[b][vb], z15.xy[b][vz]
        assert len(pz) >= len(pb) - 1  # no wholesale detection loss
        dist = np.linalg.norm(pb[:, None] - pz[None], axis=-1).min(1)
        assert (dist < 3.0).all()      # every marker still matches its peer
        assert np.percentile(dist, 99) < 1.5


@pytest.mark.parametrize("quality", [20, 70, 95])
@pytest.mark.parametrize("shape", [(480, 640), (41, 67)])
def test_tdelta_transport_matches_dense(quality, shape):
    """The TDELTA (temporal-delta) transport must reproduce the dense path
    BITWISE across the temporal cases that define it: a static run
    (replenishment: ships ~nothing), local motion, a full scene cut
    (every block re-ships), a uniform frame, and a hard-edge frame whose
    deltas exceed the EXT int8 range (spill stream)."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    base = _textured(*shape, seed=1)
    imgs = [base, base.copy(), base.copy()]          # static run
    moved = base.copy()
    moved[10:30, 10:40] = 255 - moved[10:30, 10:40]  # local motion
    imgs.append(moved)
    imgs.append(_textured(*shape, seed=9))           # scene cut
    imgs.append(np.full(shape, 128, np.uint8))       # uniform
    imgs.append((_textured(*shape, seed=7) > 127).astype(np.uint8) * 255)
    jpegs = []
    for img in imgs:
        ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY,
                                             quality])
        assert ok
        jpegs.append(enc.tobytes())
    dec = MjpegBatchDecoder()
    dense = np.asarray(dec.decode(jpegs))
    td = np.asarray(dec.decode_tdelta(jpegs))
    assert (dense == td).all()
    assert dec.last_stats["transport"] == "tdelta"


def test_tdelta_static_stream_ships_almost_nothing():
    """The transport's reason to exist: after the first (absolute) frame, a
    bit-identical stream costs only tail-pad/bucket overhead. The whole
    16-frame batch must ship less than ~3 frames' worth of the split
    transport (frame 0's absolute costs ~1.3x a split frame: no DC nibble
    lane, the block DCs ride EXT pairs)."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    img = _textured(120, 160, seed=2)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 70])
    jpegs = [enc.tobytes()] * 16
    dec = MjpegBatchDecoder()
    dec.decode_tdelta(jpegs)
    td_bytes = dec.last_stats["bytes_shipped"]
    dec2 = MjpegBatchDecoder()
    dec2.decode_split(jpegs)
    split_bytes = dec2.last_stats["bytes_shipped"]
    assert td_bytes < 3 * split_bytes / 16 + 8192


def test_tdelta_noise_degradation_bounded():
    """Adversarial (iid noise) streams kill replenishment — every block
    changes every frame. The format must stay EXACT and its bytes must stay
    within the documented bound (~2x the split transport's entry count)."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    rng = np.random.default_rng(3)
    jpegs = []
    for _ in range(6):
        img = rng.integers(0, 256, (120, 160), np.uint8)
        ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 70])
        jpegs.append(enc.tobytes())
    dec = MjpegBatchDecoder()
    dense = np.asarray(dec.decode(jpegs))
    td = np.asarray(dec.decode_tdelta(jpegs))
    assert (dense == td).all()
    td_bytes = dec.last_stats["bytes_shipped"]
    dec2 = MjpegBatchDecoder()
    dec2.decode_split(jpegs)
    assert td_bytes <= 2.5 * dec2.last_stats["bytes_shipped"]


def test_tdelta_capacity_growth():
    """Undersized tdelta streams must grow on their capacity rcs (VLC
    bytes, spill) and converge — not loop or misdecode."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    img = _textured(64, 96, seed=9)
    img[::8] = 255  # DC jumps -> deltas past int8 -> spill traffic
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    dec = MjpegBatchDecoder()
    ref = np.asarray(dec.decode([enc.tobytes()]))
    dec._tcap, dec._tscap = 8, 8
    out = np.asarray(dec.decode_tdelta([enc.tobytes()]))
    assert (out == ref).all()


def test_tdelta_error_protocol():
    """Failure protocol matches the other transports: the index of the
    first bad frame, no growth retries on malformed bytes."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    good = [cv2.imencode(".jpg", _textured(120, 160, seed=s),
                         [cv2.IMWRITE_JPEG_QUALITY, 70])[1].tobytes()
            for s in range(4)]
    dec = MjpegBatchDecoder()
    dec.decode_tdelta(good)  # learn geometry
    with pytest.raises(ValueError, match="frame 2"):
        dec.decode_tdelta(good[:2] + [good[3][:40]] + good[3:])


@pytest.mark.parametrize("workers", [2, 3, 7])
def test_multithreaded_tdelta_matches_serial(workers):
    """The MT tdelta decode seeds each worker's temporal predictor by
    silently decoding the frame before its slice, then stitches one
    stream — decoded frames must be bitwise-identical to serial across
    static runs (empty slices), motion, cuts, and spill-heavy frames."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    base = _textured(120, 160, seed=4)
    jpegs = []
    for seed in range(9):
        if seed in (1, 2, 6):
            img = base  # static repeats -> empty slices for some workers
        elif seed == 3:
            img = np.full((120, 160), 128, np.uint8)
        elif seed == 5:
            img = (_textured(120, 160, seed=seed) > 127).astype(np.uint8) * 255
        else:
            img = _textured(120, 160, seed=seed)
        ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 70])
        assert ok
        jpegs.append(enc.tobytes())
    serial = np.asarray(MjpegBatchDecoder(workers=1).decode_tdelta(jpegs))
    mt = np.asarray(MjpegBatchDecoder(workers=workers).decode_tdelta(jpegs))
    assert (serial == mt).all()


@pytest.mark.parametrize("zmax", [2, 6, 15, 22])
def test_tdelta_band_limit_matches_zeroed_dense(zmax):
    """tdelta zmax semantics match split's exactly: identical to the dense
    decode with zigzag indices >= zmax zeroed — INCLUDING the temporal
    comparison (a block whose only change is past the band ships nothing)."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    base = _textured(64, 96, seed=11)
    imgs = [base, base.copy(), _textured(64, 96, seed=12)]
    jpegs = [cv2.imencode(".jpg", im, [cv2.IMWRITE_JPEG_QUALITY, 70])[1]
             .tobytes() for im in imgs]
    dec = MjpegBatchDecoder()
    td = np.asarray(dec.decode_tdelta(jpegs, zmax=zmax))
    dec2 = MjpegBatchDecoder()
    sp = np.asarray(dec2.decode_split(jpegs, zmax=zmax))
    assert (td == sp).all()


def test_tdelta_batch_independence():
    """Every batch is self-contained (its first frame deltas against
    zeros): decoding a stream in one batch or two must agree bitwise."""
    _lib_or_skip()
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    base = _textured(120, 160, seed=6)
    imgs = [base]
    for i in range(5):
        nxt = imgs[-1].copy()
        nxt[20:40, 10 * i:10 * i + 30] ^= 0x7F
        imgs.append(nxt)
    jpegs = [cv2.imencode(".jpg", im, [cv2.IMWRITE_JPEG_QUALITY, 70])[1]
             .tobytes() for im in imgs]
    dec = MjpegBatchDecoder()
    whole = np.asarray(dec.decode_tdelta(jpegs))
    dec2 = MjpegBatchDecoder()
    a = np.asarray(dec2.decode_tdelta(jpegs[:3]))
    b = np.asarray(dec2.decode_tdelta(jpegs[3:]))
    assert (whole == np.concatenate([a, b])).all()
