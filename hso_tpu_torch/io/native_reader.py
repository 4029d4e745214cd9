"""Prefetching dataset reader: frames decoded by worker processes into a
bounded ring of shared buffers and handed out in index order.

The port's counterpart of the JAX package's ``hso_tpu.io.native_reader``
(a ctypes wrapper of ``native/hso_io.cpp``, which decodes with OpenCV on
worker threads).  The port decodes with its own PNG codec and resize
(:func:`hso_tpu_torch.io.image_reader.read_resized`), so a frame has exactly
``ImageReader.read_image``'s pixels and needs no OpenCV.  The codec's average
and Paeth unfilters are Python loops that hold the interpreter lock, so the
workers are processes, not threads, and the tracking loop keeps its
interpreter.  A worker is a lean interpreter running this module
(``python -m hso_tpu_torch.io.native_reader --worker …``): it imports numpy
and the codec, not torch and not the caller's main module, so it starts in a
fraction of a second.

A stream of frames ``start..end-1`` keeps at most ``depth`` of them decoded
or in decoding.  The ring is a file of ``depth`` frames in a temporary
directory, mapped by every process (the page cache is the shared memory):
frame i goes to slot ``i % depth`` and to worker ``i % n_workers``, which
works through its frames in order and answers one line a frame on its
standard output, so the stream reads each frame's answer from its worker in
index order.  Frame ``i + depth`` is handed out only after frame i was taken
out of its slot.  A frame that fails to decode raises ``IOError`` naming its
index when the stream reaches it; so does a worker that dies.  ``close()``
stops the workers at once, also in the middle of a stream.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

from hso_tpu_torch.io.image_reader import list_images, read_resized

#: the directory that holds the ``hso_tpu_torch`` package (a worker's path)
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def native_available() -> bool:
    """Always true: the reader needs no library of its own."""
    return True


def _worker(ring_path: str, w: int, h: int, depth: int) -> None:
    """A worker's loop: each line ``<index> <path>`` on standard input is
    decoded into ring slot ``index % depth`` and answered ``<index>`` or
    ``<index> ERR <text>`` on standard output; end of input ends it."""
    ring = np.memmap(ring_path, np.uint8, mode="r+", shape=(depth, h, w))
    for line in sys.stdin:
        i, path = line.rstrip("\n").split(" ", 1)
        try:
            ring[int(i) % depth] = read_resized(path, (w, h))
            answer = i
        except Exception as exc:           # reported, raised by the stream
            answer = f"{i} ERR {type(exc).__name__}: {exc}".replace("\n", " ")
        sys.stdout.write(answer + "\n")
        sys.stdout.flush()


class _Stream:
    """One prefetching run over frames ``start..end-1``."""

    def __init__(self, files, size_wh, start, end, n_workers, depth):
        w, h = size_wh
        self.files, self.depth, self.next, self.end = files, depth, start, end
        self.dir = tempfile.mkdtemp(prefix="hso_reader_")
        ring_path = os.path.join(self.dir, "ring")
        self.ring = np.memmap(ring_path, np.uint8, mode="w+", shape=(depth, h, w))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_PARENT, env.get("PYTHONPATH")) if p)
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "hso_tpu_torch.io.native_reader", "--worker", ring_path,
             str(w), str(h), str(depth)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            env=env, text=True, bufsize=1) for _ in range(max(1, n_workers))]
        for i in range(start, min(end, start + depth)):
            self._hand_out(i)

    def _hand_out(self, i: int) -> None:
        p = self.procs[i % len(self.procs)]
        p.stdin.write(f"{i} {self.files[i]}\n")
        p.stdin.flush()

    def take(self) -> tuple[int, np.ndarray]:
        """The next frame in index order, once its worker has decoded it."""
        i = self.next
        p = self.procs[i % len(self.procs)]
        answer = p.stdout.readline().rstrip("\n")
        if not answer:
            raise IOError(f"a reader worker ended (exit code {p.poll()}) before index {i} "
                          "was decoded")
        idx, _, err = answer.partition(" ERR ")
        if int(idx) != i:
            raise IOError(f"reader worker answered index {idx} for index {i}")
        if err:
            raise IOError(f"decode failed for index {i} ({err})")
        img = np.array(self.ring[i % self.depth])
        self.next += 1
        if i + self.depth < self.end:
            self._hand_out(i + self.depth)         # slot i % depth is free again
        return i, img

    def stop(self) -> None:
        """End of input stops an idle worker; one still decoding (a stream
        closed in its middle) is terminated."""
        for p in self.procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        for p in self.procs:
            try:
                p.wait(timeout=0.5)
            except subprocess.TimeoutExpired:
                p.terminate()
                p.wait(timeout=10)
            p.stdout.close()
        del self.ring
        shutil.rmtree(self.dir, ignore_errors=True)


class NativeImageReader:
    """Sequential prefetching reader over a dataset directory (the JAX API):
    ``read_image(i)`` decodes one frame in this process; ``start(start, end)``
    then iterating gives ``(index, image)`` in order from ``n_workers``
    processes, at most ``depth`` frames ahead."""

    def __init__(self, folder: str, size_wh: tuple[int, int], n_workers: int = 3,
                 depth: int = 8):
        self.files = list_images(folder)
        if not self.files:
            raise IOError(f"cannot open {folder}: no images")
        self.size_wh = tuple(size_wh)
        self.n_workers = n_workers
        self.depth = depth
        self._stream: _Stream | None = None

    def __len__(self) -> int:
        return len(self.files)

    def path(self, i: int) -> str:
        return self.files[i]

    def read_image(self, i: int) -> np.ndarray:
        try:
            return read_resized(self.files[i], self.size_wh)
        except (OSError, ValueError) as exc:
            raise IOError(f"decode failed for index {i} ({exc})") from exc

    def start(self, start: int = 0, end: int | None = None) -> None:
        """Start prefetching frames ``start..end-1`` (a stream already running
        is stopped first)."""
        self.close()
        end = len(self) if end is None else min(end, len(self))
        self._stream = _Stream(self.files, self.size_wh, start, end, self.n_workers,
                               self.depth)

    def __iter__(self):
        s = self._stream
        try:
            while s is not None and s.next < s.end:
                yield s.take()
        finally:
            if self._stream is s:
                self.close()

    def close(self) -> None:
        """Stop the workers (also in the middle of a stream)."""
        if self._stream is not None:
            self._stream.stop()
            self._stream = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]))
