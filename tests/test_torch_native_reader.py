"""The port's prefetching reader (``hso_tpu_torch.io.native_reader``): the
three cases of ``tests/test_native_io.py`` held to the port's
``ImageReader``, pixel for pixel, plus a damaged file and a stream closed in
the middle.  Twelve random 160×120 grey frames, written as PNG by the port's
codec (seed 0)."""

import os
import time

import numpy as np
import pytest

from hso_tpu_torch.io.image_reader import ImageReader, write_png
from hso_tpu_torch.io.native_reader import NativeImageReader, native_available


@pytest.fixture
def dataset(tmp_path):
    rng = np.random.default_rng(0)
    imgs = []
    for i in range(12):
        img = rng.integers(0, 255, (120, 160), dtype=np.uint8)
        write_png(str(tmp_path / f"frame_{i:04d}.png"), img)
        imgs.append(img)
    return tmp_path, imgs


def test_random_access(dataset):
    d, imgs = dataset
    assert native_available()
    r = NativeImageReader(str(d), (160, 120))
    assert len(r) == 12
    np.testing.assert_array_equal(r.read_image(3), imgs[3])
    np.testing.assert_array_equal(r.read_image(3), ImageReader(str(d), (160, 120)).read_image(3))
    assert r.path(0).endswith("frame_0000.png")
    r.close()


def test_resize(dataset):
    d, _ = dataset
    r = NativeImageReader(str(d), (80, 60))
    out = r.read_image(0)
    assert out.shape == (60, 80) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, ImageReader(str(d), (80, 60)).read_image(0))
    r.close()


def test_prefetch_stream(dataset):
    d, imgs = dataset
    r = NativeImageReader(str(d), (160, 120), n_workers=3, depth=4)
    r.start(2, 10)
    seen = []
    for idx, img in r:
        seen.append(idx)
        np.testing.assert_array_equal(img, imgs[idx])
    assert seen == list(range(2, 10))
    assert r._stream is None                    # the workers stopped at the end
    r.close()


def test_prefetch_stream_resized_matches_image_reader(dataset):
    d, _ = dataset
    ref = ImageReader(str(d), (80, 60))
    r = NativeImageReader(str(d), (80, 60), n_workers=2, depth=3)
    r.start()
    got = dict(iter(r))
    assert sorted(got) == list(range(12))
    for i, img in got.items():
        np.testing.assert_array_equal(img, ref.read_image(i))


def test_damaged_file_raises_with_its_index(dataset):
    d, imgs = dataset
    path = d / "frame_0005.png"
    data = bytearray(path.read_bytes())
    data[60] ^= 0xFF                            # inside IDAT: the CRC no longer holds
    path.write_bytes(bytes(data))
    r = NativeImageReader(str(d), (160, 120), n_workers=2, depth=4)
    with pytest.raises(IOError, match="index 5"):
        r.read_image(5)
    r.start(3, 9)
    seen = []
    with pytest.raises(IOError, match="index 5"):
        for idx, img in r:
            seen.append(idx)
            np.testing.assert_array_equal(img, imgs[idx])
    assert seen == [3, 4]
    assert r._stream is None
    r.close()


def test_close_in_the_middle_of_a_stream(dataset):
    d, imgs = dataset
    r = NativeImageReader(str(d), (160, 120), n_workers=3, depth=4)
    r.start(0, 12)
    it = iter(r)
    idx, img = next(it)
    assert idx == 0
    np.testing.assert_array_equal(img, imgs[0])
    procs = list(r._stream.procs)
    ring_dir = r._stream.dir
    r.close()
    t0 = time.time()
    while any(p.poll() is None for p in procs) and time.time() - t0 < 10:
        time.sleep(0.05)
    assert not any(p.poll() is None for p in procs)
    assert r._stream is None and not os.path.exists(ring_dir)
    # a new stream after the close
    r.start(10, 12)
    assert [i for i, _ in r] == [10, 11]
