"""Fused feature alignment + NCC + gradient sample: CUDA kernel K4.

Counterpart of the JAX package's ``ops/align_pallas.py``
(``align_match_tpu``).  Device code: ``csrc/align.cu``.  The plain version
chains :func:`~hso_tpu_torch.ops.align.align_mixed`,
:func:`~hso_tpu_torch.ops.align.ncc` and
:func:`~hso_tpu_torch.ops.gatherless.sample_gradient_in_windows`.  Dispatch
rule: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel or raises.

The kernel gives a candidate to one warp, which branches once on the
candidate's kind, leaves the iteration loop as soon as the candidate is no
longer active (exact: an inactive candidate keeps its state), and never
enters it for ``valid = 0``.
"""

from __future__ import annotations

import torch

from hso_tpu_torch.ops.align import align_mixed, ncc
from hso_tpu_torch.ops.gatherless import sample_gradient_in_windows

LAUNCHES = {"align_match": 0}

#: rows of the packed (8, S) result
ROW_U, ROW_V, ROW_CONV, ROW_NCC, ROW_GX, ROW_GY, ROW_CHI2, ROW_MEAN = range(8)

WARPS_PER_BLOCK = 4       #: candidates (warps) of one block, while shared memory allows
SMEM_MAX = 232448         #: dynamic shared memory a block may ask for (227 KB)


def align_launch_plan(s: int, win: int) -> tuple:
    """The launch of K4 from the shape alone: ``(warps_per_block, threads,
    smem_bytes)``.  Every warp holds its candidate's window (``win²`` floats
    rounded to 16 bytes) in shared memory.  Raises when one window does not
    fit.  Mirrors ``plan_of`` in ``csrc/align.cu``."""
    win_bytes = (win * win + 3) // 4 * 4 * 4
    warps = max(1, min(WARPS_PER_BLOCK, s))
    while warps > 1 and warps * win_bytes > SMEM_MAX:
        warps -= 1
    if warps * win_bytes > SMEM_MAX:
        raise ValueError(f"a {win}x{win} window needs {win_bytes} bytes of shared memory, "
                         f"more than {SMEM_MAX}")
    return warps, 32 * warps, warps * win_bytes


def align_match_plain(is_edge, direction, ref_border, px_init, valid, windows,
                      au, av, hs, ws, win: int, n_iter: int = 10) -> torch.Tensor:
    """Packed (8, S) float32: rows [u, v, converged, ncc, gx, gy, chi2,
    mean_diff]."""
    assert windows.shape[1] == win
    rm = align_mixed(is_edge, direction, ref_border, px_init, n_iter=n_iter, valid=valid,
                     windows=windows, anchors=(au, av), img_hw=(hs, ws))
    px = rm["px"]
    score = ncc(ref_border[:, 1:9, 1:9], rm["cur_patch"])
    gx, gy = sample_gradient_in_windows(windows, au, av, px[:, 0], px[:, 1])
    return torch.stack([px[:, 0], px[:, 1], rm["converged"].to(torch.float32), score,
                        gx, gy, rm["chi2"], rm["mean_diff"]], dim=0)


def align_match_prepare(is_edge, direction, ref_border, px_init, valid, windows,
                        au, av, hs, ws, win: int, n_iter: int = 10):
    """Check the tensors and prepare one launch of K4: returns ``(launch,
    out)`` with ``out`` the packed (8, S) result.  ``launch()`` enqueues
    ``hso_align_match`` on the stream that was current here and adds one to
    the count (nothing is enqueued for S = 0); a timing loop calls it again
    and again without the wrapper's tensor work."""
    from hso_tpu_torch import _cuda_build

    _want = _cuda_build.check_tensor
    dev = windows.device
    s = windows.shape[0]
    _want(is_edge, torch.bool, (s,), dev, "is_edge")
    _want(direction, torch.float32, (s, 2), dev, "direction")
    _want(ref_border, torch.float32, (s, 10, 10), dev, "ref_border")
    _want(px_init, torch.float32, (s, 2), dev, "px_init")
    _want(valid, torch.bool, (s,), dev, "valid")
    _want(windows, torch.float32, (s, win, win), dev, "windows")
    for name, t in (("au", au), ("av", av), ("hs", hs), ("ws", ws)):
        _want(t, torch.int32, (s,), dev, name)
    align_launch_plan(s, win)                         # raises beyond shared memory
    out = torch.empty((8, s), dtype=torch.float32, device=dev)
    if s == 0:
        return (lambda: None), out
    fn = _cuda_build.lib().hso_align_match
    # the tuple keeps every tensor the kernel reads alive as long as `launch`
    alive = (is_edge, direction, ref_border, px_init, valid, windows, au, av, hs, ws, out)
    args = tuple(t.data_ptr() for t in alive[:10]) + (
        s, win, n_iter, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)

    def launch(_alive=alive):
        _cuda_build.check(fn(*args), "hso_align_match")
        LAUNCHES["align_match"] += 1

    return launch, out


def align_match_cuda(is_edge, direction, ref_border, px_init, valid, windows,
                     au, av, hs, ws, win: int, n_iter: int = 10) -> torch.Tensor:
    """K4: launch ``hso_align_match`` on the current stream (one warp per
    candidate, ``align_launch_plan`` warps per block)."""
    launch, out = align_match_prepare(is_edge, direction, ref_border, px_init, valid, windows,
                                      au, av, hs, ws, win, n_iter)
    launch()
    return out


def align_match(is_edge, direction, ref_border, px_init, valid, windows,
                au, av, hs, ws, win: int, n_iter: int = 10) -> torch.Tensor:
    """Align every candidate, score it and sample its gradient direction."""
    if windows.is_cuda:
        c = torch.Tensor.contiguous
        return align_match_cuda(c(is_edge), c(direction), c(ref_border), c(px_init),
                                c(valid), c(windows), c(au), c(av), c(hs), c(ws),
                                win, n_iter)
    return align_match_plain(is_edge, direction, ref_border, px_init, valid, windows,
                             au, av, hs, ws, win, n_iter)
