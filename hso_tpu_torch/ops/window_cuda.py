"""Per-feature window extraction: CUDA kernels K1/K2 and their plain versions.

Counterpart of the JAX package's ``ops/window_pallas.py``
(``extract_windows_tpu``, ``pack_level_windows_tpu``).  The device code is
``csrc/window.cu``: one window-gather kernel, one warp per window, that copies
with 16-byte loads and stores where the source allows it and with 4-byte loads
elsewhere (:func:`window_copy_plan` decides before the launch), from up to 8
sources per launch — K1's jobs (:func:`extract_windows_multi`) or K2's
per-row pyramid level.  Dispatch rule: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises — there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

#: launches of each kernel since the counter was last set to 0
LAUNCHES = {"extract_windows": 0, "pack_level_windows": 0}

MAX_SOURCES = 8            #: images (K1 jobs) or pyramid levels (K2) one launch reads
MAX_ALIGNED_WIN = 124      #: the aligned body gives a window row's chunks to one warp


def window_copy_plan(h: int, w: int, win: int, base_addr: int) -> tuple:
    """How one launch copies (win × win) windows out of an (h, w) float32
    image at address ``base_addr``: ``(aligned, windows_per_block, threads)``.
    The aligned body (16-byte loads and stores) takes the source when its base
    is 16-byte aligned, its row pitch ``4w`` a multiple of 16 and ``win`` a
    multiple of 4 from 4 to 124; otherwise the general body copies it with
    4-byte loads.  One warp per window, 8 windows a block up to win 32 and 4
    above.  Mirrors ``window_plan`` in ``csrc/window.cu``."""
    if h < 1 or w < 1 or win < 1:
        raise ValueError(f"no window plan for a {h}x{w} image and win {win}")
    windows = 8 if win <= 32 else 4
    aligned = (base_addr % 16 == 0 and (4 * w) % 16 == 0 and win % 4 == 0
               and 4 <= win <= MAX_ALIGNED_WIN)
    return aligned, windows, 32 * windows


def extract_windows_plain(img: torch.Tensor, au: torch.Tensor, av: torch.Tensor,
                          win: int) -> torch.Tensor:
    """(N, win, win) windows at integer top-left anchors by advanced indexing.
    Rows/columns outside the image read 0 (callers pre-clip the anchors with
    ``clip_anchor``, so that does not happen on the main path)."""
    h, w = img.shape
    ar = torch.arange(win, device=img.device, dtype=torch.int64)
    rows = av.to(torch.int64)[:, None] + ar[None, :]            # (N, win)
    cols = au.to(torch.int64)[:, None] + ar[None, :]
    inside = (((rows >= 0) & (rows < h))[:, :, None]
              & ((cols >= 0) & (cols < w))[:, None, :])
    vals = img[rows.clamp(0, h - 1)[:, :, None], cols.clamp(0, w - 1)[:, None, :]]
    return torch.where(inside, vals, torch.zeros_like(vals))


def extract_windows_multi_plain(jobs, win: int) -> list:
    """One (N_j, win, win) window tensor per job ``(img, au, av)``."""
    return [extract_windows_plain(img, au, av, win) for img, au, av in jobs]


def extract_windows_multi_prepare(jobs, win: int):
    """Check the tensors and prepare one launch of K1 over up to 8 jobs
    ``(img, au, av)``: returns ``(launch, outs)``.  ``launch()`` enqueues
    ``hso_extract_windows_jobs`` on the stream that was current here and adds
    one to the count (nothing is enqueued when no job has a window)."""
    from hso_tpu_torch import _cuda_build

    if not 1 <= len(jobs) <= MAX_SOURCES:
        raise ValueError(f"{len(jobs)} jobs: one launch takes 1 to {MAX_SOURCES}")
    dev = jobs[0][0].device
    check = _cuda_build.check_tensor
    table = (_cuda_build.WindowJob * len(jobs))()
    outs = []
    for j, (img, au, av) in enumerate(jobs):
        n = au.shape[0]
        check(img, torch.float32, img.shape[-2:], dev, f"jobs[{j}].img")
        check(au, torch.int32, (n,), dev, f"jobs[{j}].au")
        check(av, torch.int32, (n,), dev, f"jobs[{j}].av")
        out = torch.empty((n, win, win), dtype=torch.float32, device=dev)
        table[j] = _cuda_build.WindowJob(img.data_ptr(), img.shape[0], img.shape[1],
                                         au.data_ptr(), av.data_ptr(), n, out.data_ptr())
        outs.append(out)
    if sum(o.shape[0] for o in outs) == 0:
        return (lambda: None), outs
    fn = _cuda_build.lib().hso_extract_windows_jobs
    stream = torch.cuda.current_stream(dev).cuda_stream
    alive = (jobs, outs)               # every tensor the kernel reads or writes

    def launch(_alive=alive):
        _cuda_build.check(fn(table, len(jobs), win, stream), "hso_extract_windows_jobs")
        LAUNCHES["extract_windows"] += 1

    return launch, outs


def extract_windows_multi_cuda(jobs, win: int) -> list:
    """K1: the windows of up to 8 jobs in one launch of ``hso_extract_windows_jobs``."""
    launch, outs = extract_windows_multi_prepare(jobs, win)
    launch()
    return outs


def extract_windows_multi(jobs, win: int) -> list:
    """The windows of several ``(img, au, av)`` jobs at one window edge:
    one launch on the card, one plain extraction per job on the CPU."""
    if jobs[0][0].is_cuda:
        return extract_windows_multi_cuda(
            [(img.contiguous(), au.contiguous(), av.contiguous()) for img, au, av in jobs], win)
    return extract_windows_multi_plain(jobs, win)


def extract_windows_prepare(img: torch.Tensor, au: torch.Tensor, av: torch.Tensor, win: int):
    """One launch of K1 through ``hso_extract_windows`` (the single-image
    entry): returns ``(launch, out)`` as :func:`extract_windows_multi_prepare`."""
    from hso_tpu_torch import _cuda_build

    dev = img.device
    n = au.shape[0]
    check = _cuda_build.check_tensor
    check(img, torch.float32, img.shape[-2:], dev, "img")
    check(au, torch.int32, (n,), dev, "au")
    check(av, torch.int32, (n,), dev, "av")
    out = torch.empty((n, win, win), dtype=torch.float32, device=dev)
    if n == 0:
        return (lambda: None), out
    fn = _cuda_build.lib().hso_extract_windows
    args = (img.data_ptr(), img.shape[0], img.shape[1], au.data_ptr(), av.data_ptr(), n, win,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)

    def launch(_alive=(img, au, av, out)):
        _cuda_build.check(fn(*args), "hso_extract_windows")
        LAUNCHES["extract_windows"] += 1

    return launch, out


def extract_windows_cuda(img: torch.Tensor, au: torch.Tensor, av: torch.Tensor,
                         win: int) -> torch.Tensor:
    """K1: launch ``hso_extract_windows`` on the current stream."""
    launch, out = extract_windows_prepare(img, au, av, win)
    launch()
    return out


def extract_windows(img: torch.Tensor, au: torch.Tensor, av: torch.Tensor,
                    win: int) -> torch.Tensor:
    """Extract (N, win, win) windows with integer top-left anchors."""
    if img.is_cuda:
        return extract_windows_cuda(img.contiguous(), au.contiguous(), av.contiguous(), win)
    return extract_windows_plain(img, au, av, win)


def pack_level_windows_plain(pyr, level: torch.Tensor, au: torch.Tensor,
                             av: torch.Tensor, win: int, n_levels: int) -> torch.Tensor:
    """Row s reads its (win × win) window from ``pyr[level[s]]`` at anchors
    (au[s], av[s]) in that level's coordinates: one extraction per level,
    merged by a masked select."""
    s = level.shape[0]
    windows = torch.zeros((s, win, win), dtype=torch.float32, device=level.device)
    for lvl in range(n_levels):
        w_lvl = extract_windows_plain(pyr[lvl], au, av, win)
        windows = torch.where((level == lvl)[:, None, None], w_lvl, windows)
    return windows


def pack_level_windows_prepare(pyr, level: torch.Tensor, au: torch.Tensor,
                               av: torch.Tensor, win: int, n_levels: int):
    """Check the tensors and prepare one launch of K2 (``hso_pack_level_windows``):
    returns ``(launch, out)`` as :func:`extract_windows_multi_prepare`."""
    from hso_tpu_torch import _cuda_build

    dev = level.device
    s = level.shape[0]
    if n_levels > _cuda_build.LevelTable.MAX_LEVELS:
        raise ValueError(f"n_levels {n_levels} exceeds {_cuda_build.LevelTable.MAX_LEVELS}")
    check = _cuda_build.check_tensor
    check(level, torch.int32, (s,), dev, "level")
    check(au, torch.int32, (s,), dev, "au")
    check(av, torch.int32, (s,), dev, "av")
    table = _cuda_build.LevelTable()
    for lvl in range(n_levels):
        check(pyr[lvl], torch.float32, pyr[lvl].shape[-2:], dev, f"pyr[{lvl}]")
        table.img[lvl] = pyr[lvl].data_ptr()
        table.h[lvl], table.w[lvl] = pyr[lvl].shape
    out = torch.empty((s, win, win), dtype=torch.float32, device=dev)
    if s == 0:
        return (lambda: None), out
    fn = _cuda_build.lib().hso_pack_level_windows
    args = (ctypes.byref(table), n_levels, level.data_ptr(), au.data_ptr(), av.data_ptr(), s,
            win, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)

    def launch(_alive=(tuple(pyr[:n_levels]), level, au, av, out, table)):
        _cuda_build.check(fn(*args), "hso_pack_level_windows")
        LAUNCHES["pack_level_windows"] += 1

    return launch, out


def pack_level_windows_cuda(pyr, level: torch.Tensor, au: torch.Tensor,
                            av: torch.Tensor, win: int, n_levels: int) -> torch.Tensor:
    """K2: launch ``hso_pack_level_windows`` on the current stream.  Rows whose
    level lies outside [0, n_levels) come back as zeros."""
    launch, out = pack_level_windows_prepare(pyr, level, au, av, win, n_levels)
    launch()
    return out


def pack_level_windows_gather(pyr, level, au, av, win: int, n_levels: int) -> torch.Tensor:
    """Dispatch of the multi-level gather (anchors already computed)."""
    if level.is_cuda:
        return pack_level_windows_cuda(
            [p.contiguous() for p in pyr[:n_levels]], level.contiguous(),
            au.contiguous(), av.contiguous(), win, n_levels)
    return pack_level_windows_plain(pyr, level, au, av, win, n_levels)
