"""Live run viewer: a file sink refreshed every N frames.

The port's counterpart of the JAX package's ``hso_tpu.utils.live_view``,
which draws with OpenCV and matplotlib.  This one needs neither: it draws
with numpy and writes with the port's own PNG writer
(:func:`hso_tpu_torch.io.image_reader.write_png`).  Every ``every``-th frame
it refreshes

    <dir>/tracking.png   the frame as RGB with a ring of radius 3 at each
                         kept match (TEMPORARY points cyan, edgelets magenta,
                         the rest green) and the counter line, drawn in a
                         5×7 bitmap font of its own;
    <dir>/map.png        a top-down x–z view of the valid map points, the
                         trajectory, the keyframe centres and the current
                         camera, scaled to the data's extent.

The pixels are not OpenCV's or matplotlib's; the positions are the JAX
viewer's: a ring's centre is the match's pixel truncated to integers, the
map shows the same world points.  ``show=True`` also shows the tracking image
with ``cv2.imshow`` where OpenCV imports, and raises where it does not.
"""

from __future__ import annotations

import os

import numpy as np

from hso_tpu_torch.io.image_reader import write_png

TYPE_TEMPORARY = 1          #: ``mapmodel.structures.TYPE_TEMPORARY``
#: RGB colours of the tracking overlay (the JAX viewer's, which are BGR)
CYAN, MAGENTA, GREEN, YELLOW = (0, 255, 255), (255, 0, 255), (0, 255, 0), (255, 255, 0)
#: RGB colours of the map (the JAX viewer's matplotlib colours)
GREY, BLUE, KF_GREEN, RED = (119, 119, 119), (31, 119, 180), (44, 160, 44), (214, 39, 40)
TEXT_ORIGIN = (8, 8)        #: top-left corner of the counter line
MAP_SIZE = 600              #: the map image is MAP_SIZE × MAP_SIZE pixels
MAP_MARGIN = 24             #: pixels between the data's extent and the border

#: 5×7 glyphs, rows top to bottom, "1" = ink; unknown characters draw "?"
_GLYPHS = {
    "0": "01110 10001 10011 10101 11001 10001 01110",
    "1": "00100 01100 00100 00100 00100 00100 01110",
    "2": "01110 10001 00001 00010 00100 01000 11111",
    "3": "11111 00010 00100 00010 00001 10001 01110",
    "4": "00010 00110 01010 10010 11111 00010 00010",
    "5": "11111 10000 11110 00001 00001 10001 01110",
    "6": "00110 01000 10000 11110 10001 10001 01110",
    "7": "11111 00001 00010 00100 01000 01000 01000",
    "8": "01110 10001 10001 01110 10001 10001 01110",
    "9": "01110 10001 10001 01111 00001 00010 01100",
    "a": "00000 00000 01110 00001 01111 10001 01111",
    "b": "10000 10000 10110 11001 10001 10001 11110",
    "c": "00000 00000 01110 10000 10000 10001 01110",
    "d": "00001 00001 01101 10011 10001 10001 01111",
    "e": "00000 00000 01110 10001 11111 10000 01110",
    "f": "00110 01001 01000 11100 01000 01000 01000",
    "g": "00000 01111 10001 10001 01111 00001 01110",
    "h": "10000 10000 10110 11001 10001 10001 10001",
    "i": "00100 00000 01100 00100 00100 00100 01110",
    "j": "00010 00000 00110 00010 00010 10010 01100",
    "k": "10000 10000 10010 10100 11000 10100 10010",
    "l": "01100 00100 00100 00100 00100 00100 01110",
    "m": "00000 00000 11010 10101 10101 10001 10001",
    "n": "00000 00000 10110 11001 10001 10001 10001",
    "o": "00000 00000 01110 10001 10001 10001 01110",
    "p": "00000 00000 11110 10001 11110 10000 10000",
    "q": "00000 00000 01101 10011 01111 00001 00001",
    "r": "00000 00000 10110 11001 10000 10000 10000",
    "s": "00000 00000 01110 10000 01110 00001 11110",
    "t": "01000 01000 11100 01000 01000 01001 00110",
    "u": "00000 00000 10001 10001 10001 10011 01101",
    "v": "00000 00000 10001 10001 10001 01010 00100",
    "w": "00000 00000 10001 10001 10101 10101 01010",
    "x": "00000 00000 10001 01010 00100 01010 10001",
    "y": "00000 00000 10001 10001 01111 00001 01110",
    "z": "00000 00000 11111 00010 00100 01000 11111",
    " ": "00000 00000 00000 00000 00000 00000 00000",
    ":": "00000 01100 01100 00000 01100 01100 00000",
    ",": "00000 00000 00000 00000 01100 00100 01000",
    ".": "00000 00000 00000 00000 00000 01100 01100",
    "-": "00000 00000 00000 11111 00000 00000 00000",
    "?": "01110 10001 00001 00010 00100 00000 00100",
}
GLYPH_W, GLYPH_H, ADVANCE = 5, 7, 6


def _glyph(ch: str) -> np.ndarray:
    rows = _GLYPHS.get(ch.lower(), _GLYPHS["?"]).split()
    return np.array([[c == "1" for c in r] for r in rows], bool)


def text_mask(text: str) -> np.ndarray:
    """(7, 6·len(text)) bool: the ink of ``text`` in the viewer's font."""
    out = np.zeros((GLYPH_H, ADVANCE * len(text)), bool)
    for i, ch in enumerate(text):
        out[:, ADVANCE * i:ADVANCE * i + GLYPH_W] = _glyph(ch)
    return out


def draw_text(vis: np.ndarray, text: str, origin: tuple[int, int], color) -> None:
    """Burn ``text`` into the RGB image ``vis`` with its top-left at ``origin``
    (x, y), clipped to the image."""
    m = text_mask(text)
    x0, y0 = origin
    h, w = vis.shape[:2]
    m = m[:max(0, h - y0), :max(0, w - x0)]
    vis[y0:y0 + m.shape[0], x0:x0 + m.shape[1]][m] = color


#: integer offsets of a ring of radius 3 (distance rounded to 3)
_RING = np.array([(dx, dy) for dy in range(-4, 5) for dx in range(-4, 5)
                  if round(float(np.hypot(dx, dy))) == 3], np.int64)


def ring_pixels(x: int, y: int, h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """(xs, ys) of the ring around (x, y) that lie inside an h × w image."""
    xs, ys = x + _RING[:, 0], y + _RING[:, 1]
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    return xs[keep], ys[keep]


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


class LiveViewer:
    def __init__(self, out_dir: str = "result/live", every: int = 10, show: bool = False):
        self.out_dir = out_dir
        self.every = max(1, every)
        self.show = show
        if show and _cv2() is None:
            raise RuntimeError("LiveViewer(show=True) shows the tracking image with "
                               "cv2.imshow, and OpenCV (cv2) is not installed; the PNG "
                               "files are written without it")
        self.count = 0
        self.traj: list[np.ndarray] = []
        self.last_text = ""
        self.rings: list[tuple[int, int, tuple]] = []   # (x, y, colour) last drawn
        self.map_view = None                           # (x0, z0, scale) last drawn
        os.makedirs(out_dir, exist_ok=True)

    def update(self, vo, img) -> None:
        """Call once per processed frame with the input image (grey, numpy or
        a tensor)."""
        from hso_tpu_torch.math import se3np

        frame = vo.last_frame
        if frame is not None:
            self.traj.append(se3np.translation(se3np.inv(frame.T_f_w)))
        self.count += 1
        if self.count % self.every:
            return
        if hasattr(img, "cpu"):
            img = img.cpu().numpy()
        self._draw_tracking(vo, np.asarray(img))
        self._draw_map(vo)

    # ------------------------------------------------------------ renderers
    def _draw_tracking(self, vo, img: np.ndarray) -> None:
        grey = np.clip(img, 0, 255).astype(np.uint8)
        vis = np.repeat(grey[..., None], 3, axis=-1)
        h, w = grey.shape
        frame = vo.last_frame
        n_inl = 0
        self.rings = []
        if frame is not None and frame.obs is not None:
            o = frame.obs
            ov = o["valid"] & (o["point_id"] >= 0)
            n_inl = int(ov.sum())
            ptype = vo.points.type[np.where(ov, o["point_id"], 0)]
            for i in np.where(ov)[0]:
                x, y = int(o["px"][i, 0]), int(o["px"][i, 1])
                if ptype[i] == TYPE_TEMPORARY:
                    color = CYAN
                elif o["species"][i] == 1:              # edgelet
                    color = MAGENTA
                else:
                    color = GREEN
                xs, ys = ring_pixels(x, y, h, w)
                vis[ys, xs] = color
                self.rings.append((x, y, color))
        self.last_text = (f"frame {self.count}  inl {n_inl}  kfs {len(vo.kfs.frames)} "
                          f"pts {int(vo.points.valid.sum())}  stage {vo.stage}")
        draw_text(vis, self.last_text, TEXT_ORIGIN, YELLOW)
        write_png(os.path.join(self.out_dir, "tracking.png"), vis)
        if self.show:
            cv2 = _cv2()
            cv2.imshow("hso_tpu_torch tracking", vis[..., ::-1])
            cv2.waitKey(1)

    def map_pixels(self, x, z) -> tuple[np.ndarray, np.ndarray]:
        """Map-image pixel (column, row) of world x, z in the last map drawn."""
        x0, z0, s = self.map_view
        u = MAP_MARGIN + (np.asarray(x, np.float64) - x0) * s
        v = MAP_SIZE - 1 - MAP_MARGIN - (np.asarray(z, np.float64) - z0) * s
        return np.floor(u).astype(np.int64), np.floor(v).astype(np.int64)

    def _draw_map(self, vo) -> None:
        from hso_tpu_torch.math import se3np

        pts = vo.points
        valid = pts.valid
        p = pts.positions(vo.kfs.poses)[valid] if valid.any() else np.zeros((0, 3))
        t = np.stack(self.traj) if self.traj else np.zeros((0, 3))
        kfc = (np.stack([se3np.translation(se3np.inv(kf.T_f_w)) for kf in vo.kfs.frames])
               if vo.kfs.frames else np.zeros((0, 3)))
        allxz = np.concatenate([p, t, kfc])[:, [0, 2]]
        allxz = allxz[np.isfinite(allxz).all(axis=1)]
        lo = allxz.min(0) if len(allxz) else np.zeros(2)
        hi = allxz.max(0) if len(allxz) else np.ones(2)
        span = float(max(hi[0] - lo[0], hi[1] - lo[1], 1e-6))
        self.map_view = (float(lo[0]), float(lo[1]), (MAP_SIZE - 1 - 2 * MAP_MARGIN) / span)
        vis = np.full((MAP_SIZE, MAP_SIZE, 3), 255, np.uint8)

        def put(x, z, color, radius=0):
            u, v = self.map_pixels(x, z)
            for dv in range(-radius, radius + 1):
                for du in range(-radius, radius + 1):
                    uu, vv = u + du, v + dv
                    ok = (uu >= 0) & (uu < MAP_SIZE) & (vv >= 0) & (vv < MAP_SIZE)
                    vis[vv[ok], uu[ok]] = color

        put(p[:, 0], p[:, 2], GREY)
        for a, b in zip(t[:-1], t[1:]):             # the trajectory, one pixel a step
            n = int(np.ceil(np.hypot(*(b - a)[[0, 2]]) * self.map_view[2])) + 1
            s = np.linspace(0.0, 1.0, n)
            put(a[0] + s * (b[0] - a[0]), a[2] + s * (b[2] - a[2]), BLUE)
        put(kfc[:, 0], kfc[:, 2], KF_GREEN, radius=1)
        if len(t):
            put(t[-1:, 0], t[-1:, 2], RED, radius=2)
        draw_text(vis, f"map: {int(valid.sum())} points, {len(vo.kfs.frames)} keyframes",
                  TEXT_ORIGIN, (0, 0, 0))
        write_png(os.path.join(self.out_dir, "map.png"), vis)
