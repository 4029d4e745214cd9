"""Dataset I/O: the port's calibration parser, image reader, PNG codec and
TUM trajectory writer against the JAX package's (``hso_tpu/io``) and OpenCV.

Calibration: every camera field of the four files in ``data/cameras/`` equal
(these stand in for ``tests/test_io.py``'s calibration tests, which read an
absent directory), remap tables equal.  PNG: the port's files read by OpenCV
and by the JAX ``ImageReader``, OpenCV's files read by the port, all equal to
the pixel; each filter type 0–4 decoded like OpenCV.  Resize without OpenCV:
within 1 grey level of ``cv2.resize(INTER_LINEAR)``.  Trajectories: the same
bytes as the JAX writer on the same poses.
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from hso_tpu.io import calib as jcalib
from hso_tpu.io import image_reader as jreader
from hso_tpu.io import trajectory as jtraj
from hso_tpu.math import se3np as jse3
from hso_tpu_torch.io import calib, image_reader, trajectory
from hso_tpu_torch.io.image_reader import ImageReader, read_png, write_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMS = os.path.join(ROOT, "data", "cameras")
CALIBS = ["euroc.txt", "icl-nuim.txt", "tum_mono_vo_narrow.txt", "tum_mono_vo_wide.txt"]


@pytest.mark.parametrize("name", CALIBS)
def test_parse_calib_equal(name):
    cj = jcalib.parse_calib(os.path.join(CAMS, name))
    ct = calib.parse_calib(os.path.join(CAMS, name))
    assert type(ct).__name__ == type(cj).__name__
    assert vars(ct) == vars(cj)                     # every field, exactly
    assert ct.width * ct.height <= calib.MAX_RESOLUTION
    if ct.undistort_image:
        for a, b in zip(ct.undistort_remap(), cj.undistort_remap()):
            np.testing.assert_array_equal(a, b)


def test_parse_calib_rescales_and_rejects(tmp_path):
    p = tmp_path / "big.txt"
    p.write_text("Pinhole 800 800 640 480 0 0 0 0\n1280 960\nfalse\n")
    cj, ct = jcalib.parse_calib(str(p)), calib.parse_calib(str(p))
    assert vars(ct) == vars(cj) and ct.width < 1280
    p.write_text("Equi 400 400 320 240 0.01 0.002 0 0\n640 480\ntrue\n")
    assert vars(calib.parse_calib(str(p))) == vars(jcalib.parse_calib(str(p)))
    p.write_text("Ortho 1 1 1 1\n640 480\n")
    with pytest.raises(ValueError):
        calib.parse_calib(str(p))


@pytest.mark.parametrize("line", ["1403636579.76 0 0 0 0 0 0 1", "7 1403636579.76 0.05",
                                  "7 1403636579.76", "1403636579.76", "", "  \n",
                                  "1 2 3 4", "a b c d e f g h i"])
def test_stamp_formats(line):
    assert image_reader._parse_stamp_line(line) == jreader._parse_stamp_line(line)


def images(seed=0):
    rng = np.random.default_rng(seed)
    out = {
        "grey8": rng.integers(0, 256, (37, 53)).astype(np.uint8),
        "rgb8": rng.integers(0, 256, (37, 53, 3)).astype(np.uint8),
        "rgba8": rng.integers(0, 256, (29, 41, 4)).astype(np.uint8),
        "grey16": rng.integers(0, 65536, (37, 53)).astype(np.uint16),
    }
    # smooth rows and grey pixels, so the encoder's filters and the grey
    # conversion's equal-channel rule both occur
    out["grey8"][10:20] = np.arange(53)[None] * 3
    out["rgb8"][5:9] = out["rgb8"][5:9, :, :1]
    return out


def as_cv2(a):
    """OpenCV's channel order (BGR, BGRA) of an array in file order."""
    if a.ndim == 3:
        return a[..., [2, 1, 0]] if a.shape[2] == 3 else a[..., [2, 1, 0, 3]]
    return a


@pytest.mark.parametrize("kind", ["grey8", "rgb8", "rgba8", "grey16"])
def test_png_written_by_the_port_reads_equal(tmp_path, kind):
    a = images()[kind]
    p = str(tmp_path / "a.png")
    write_png(p, a)
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), as_cv2(a))
    np.testing.assert_array_equal(read_png(p), a)
    grey = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(image_reader.read_grey(p), grey)
    shape = (a.shape[1], a.shape[0])
    np.testing.assert_array_equal(jreader.ImageReader(str(tmp_path), shape).read_image(0),
                                  ImageReader(str(tmp_path), shape).read_image(0))


@pytest.mark.parametrize("kind", ["grey8", "rgb8", "rgba8", "grey16"])
def test_png_written_by_opencv_reads_equal(tmp_path, kind):
    a = images(1)[kind]
    p = str(tmp_path / "a.png")
    cv2.imwrite(p, as_cv2(a))
    np.testing.assert_array_equal(read_png(p), a)
    np.testing.assert_array_equal(image_reader.read_grey(p), cv2.imread(p, cv2.IMREAD_GRAYSCALE))


def filtered_png(path, a, ftypes, bpp):
    """Write ``a`` (uint8 or uint16) with the given filter type per row, by a
    direct transcription of the PNG filter definitions."""
    h, w = a.shape[:2]
    depth, ctype = (16, 0) if a.dtype == np.uint16 else (8, {1: 0, 3: 2, 4: 6}[bpp])
    rows = np.ascontiguousarray(a.astype(">u2") if depth == 16 else a).view(np.uint8)
    rows = rows.reshape(h, -1).astype(np.int64)
    raw = bytearray()
    for r in range(h):
        cur, prev = rows[r], rows[r - 1] if r else np.zeros_like(rows[r])
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        f = ftypes[r % len(ftypes)]
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw += bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                                  ctype, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftypes", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)])
@pytest.mark.parametrize("kind", ["grey8", "rgb8", "grey16"])
def test_png_filter_types(tmp_path, ftypes, kind):
    a = images(2)[kind]
    bpp = {"grey8": 1, "rgb8": 3, "grey16": 2}[kind]
    p = str(tmp_path / "f.png")
    filtered_png(p, a, ftypes, bpp)
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), as_cv2(a))
    np.testing.assert_array_equal(read_png(p), a)


def patch_ihdr(path, index, value):
    """Set one byte of a PNG's IHDR data, with a valid CRC."""
    buf = bytearray(open(path, "rb").read())
    ihdr = bytearray(buf[16:29])
    ihdr[index] = value
    buf[16:29] = ihdr
    buf[29:33] = struct.pack(">I", zlib.crc32(b"IHDR" + bytes(ihdr)) & 0xFFFFFFFF)
    open(path, "wb").write(bytes(buf))
    return buf


def test_png_refuses_what_it_does_not_read(tmp_path):
    p = str(tmp_path / "i.png")
    write_png(p, images()["grey8"])
    buf = patch_ihdr(p, 12, 1)                            # interlace method
    with pytest.raises(ValueError, match="interlaced"):
        read_png(p)
    buf[40] ^= 0xFF                                       # a damaged chunk
    open(p, "wb").write(bytes(buf))
    with pytest.raises(ValueError, match="damaged"):
        read_png(p)
    open(p, "wb").write(bytes(buf[:60]))                  # cut inside the IDAT chunk
    with pytest.raises(ValueError, match="truncated"):
        read_png(p)
    for ctype, depth in ((4, 8), (3, 8), (2, 16), (0, 4)):   # grey+alpha, palette, ...
        write_png(p, images()["grey8"])
        patch_ihdr(p, 9, ctype)
        patch_ihdr(p, 8, depth)
        with pytest.raises(ValueError, match="colour type"):
            read_png(p)
    with pytest.raises(ValueError):
        write_png(p, np.zeros((4, 4), np.float32))


def test_image_reader_against_jax(tmp_path):
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.default_rng(3)
    for i in range(3):
        write_png(str(d / f"{i:03d}.png"), rng.integers(0, 256, (120, 160), dtype=np.uint8))
    cv2.imwrite(str(d / "003.jpg"), rng.integers(0, 256, (120, 160), dtype=np.uint8))
    times = tmp_path / "times.txt"
    times.write_text("".join(f"{i} {100.5 + i}\n" for i in range(4)))
    for size in ((160, 120), (80, 60)):
        rj = jreader.ImageReader(str(d), size, str(times))
        rt = ImageReader(str(d), size, str(times))
        assert rt.files == rj.files and rt.stamp_valid and len(rt) == 4
        for i in range(4):
            np.testing.assert_array_equal(rt.read_image(i), rj.read_image(i))
            assert rt.read_stamp(i) == rj.read_stamp(i)
    rt = ImageReader(str(d), (160, 120), None)
    assert not rt.stamp_valid and rt.read_stamp(2) == "2"


@pytest.mark.parametrize("size", [(53, 37), (100, 80), (640, 480), (20, 15), (64, 48)])
def test_resize_without_opencv_within_one_grey_level(size):
    """The torch resize (used where OpenCV is not installed) against
    ``cv2.resize(INTER_LINEAR)``: at most 1 grey level apart (OpenCV rounds
    fixed-point weights of 11 bits)."""
    a = np.random.default_rng(4).integers(0, 256, (37, 53)).astype(np.uint8)
    got = image_reader.resize_bilinear(a, size)
    ref = cv2.resize(a, size, interpolation=cv2.INTER_LINEAR)
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_reader_without_opencv(tmp_path, monkeypatch):
    """No OpenCV: PNG still reads (resized by the torch path), other formats
    raise an error that names the format."""
    rng = np.random.default_rng(5)
    write_png(str(tmp_path / "0.png"), rng.integers(0, 256, (48, 64), dtype=np.uint8))
    cv2.imwrite(str(tmp_path / "1.jpg"), rng.integers(0, 256, (48, 64), dtype=np.uint8))
    monkeypatch.setattr(image_reader, "_cv2", lambda: None)
    r = ImageReader(str(tmp_path), (32, 24))
    img = r.read_image(0)
    ref = cv2.resize(read_png(r.files[0]), (32, 24), interpolation=cv2.INTER_LINEAR)
    assert np.abs(img.astype(int) - ref.astype(int)).max() <= 1
    with pytest.raises(RuntimeError, match=r"\.jpg"):
        r.read_image(1)


def test_rotation_to_quaternion_equal():
    rng = np.random.default_rng(6)
    Rs = [jse3.rotation(jse3.exp(rng.normal(0, 1.5, 6))) for _ in range(200)]
    # each branch of Shepperd's method: trace > 0 and each largest diagonal
    Rs += [np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]), np.diag([-1.0, -1.0, 1.0])]
    for R in Rs:
        np.testing.assert_array_equal(trajectory.rotation_to_quaternion(R),
                                      jtraj.rotation_to_quaternion(R))


def test_save_keyframe_trajectory_bytes_equal(tmp_path):
    class KF:
        def __init__(self, T, ts, stamp):
            self.T_f_w, self.timestamp = T, ts
            if stamp is not None:
                self.stamp_str = stamp

    class Handler:
        class kfs:
            frames = []

    rng = np.random.default_rng(7)
    Handler.kfs.frames = [KF(jse3.exp(rng.normal(0, 0.8, 6)), float(k),
                             None if k % 3 == 0 else f"{1403636579 + k / 20:.6f}")
                          for k in range(40)]
    pj, pt = tmp_path / "j" / "t.txt", tmp_path / "t" / "t.txt"
    assert jtraj.save_keyframe_trajectory(Handler, str(pj)) == 40
    assert trajectory.save_keyframe_trajectory(Handler, str(pt)) == 40
    assert pt.read_bytes() == pj.read_bytes()
