"""Dense ZMNCC epipolar line search: CUDA kernel K6 and its plain version.

Counterpart of the JAX package's ``ops/epipolar_pallas.py``
(``zmncc_line_scores_tpu``).  Device code: ``csrc/epipolar.cu``.  For every
seed: the zero-mean NCC of its 8×8 template at every patch position of its
search window (an (EW−7)² score map from the box sums Σt, Σt² and the
correlation Σr·t), two-tap samples of that map at ``n_steps`` points along
the epipolar segment, a window/image-bounds mask, then the best score, the
second-best at step distance > 1 and the first step that reaches the best.

Dispatch rule: a CPU tensor takes the plain version, a CUDA tensor launches
the kernel or raises.

The kernel gives a seed to a group of 64 threads, several groups to a block
(:func:`zmncc_launch_plan`), leaves a seed with no step inside its window
before anything of it is read, and computes only the map entries its line reads;
a seed whose window or template holds a non-finite or huge value scans its
whole map first, so that the dense form's rule (one non-finite map entry
turns every unmasked score of the seed into NaN) holds exactly.

The plain version fixes the order of every sum that feeds the two
cancelling differences (``Σt² − (Σt)²/64`` and ``corr − mean·Σt``): box
sums as separable shifted adds left to right then top to bottom, the
correlation as 64 shifted multiply-adds row by row, the template sums as a
halving tree.  The kernel takes the same sums in the same order, so the
score maps agree to rounding of the final division even on flat patches.
"""

from __future__ import annotations

import torch

LAUNCHES = {"zmncc_line_scores": 0}

PATCH = 8
GROUP = 64                #: threads of one seed
SEEDS_PER_BLOCK = 2       #: seed groups of one block, while shared memory allows
SMEM_MAX = 232448         #: dynamic shared memory a block may ask for (227 KB)


def zmncc_launch_plan(s: int, ew: int, n_steps: int) -> tuple:
    """The launch of K6 from the shape alone: ``(seeds_per_block, threads,
    smem_bytes)``.  A seed holds its window, four map entries and one score
    per step and eight flag words in shared memory, rounded to 16 bytes; a
    block takes ``SEEDS_PER_BLOCK`` seeds (no more than there are), fewer
    while they do not fit.  Raises when one seed does not fit.  Mirrors
    ``plan_of`` in ``csrc/epipolar.cu``."""
    seed_bytes = (ew * ew + 5 * n_steps + 8 + 3) // 4 * 4 * 4
    seeds = max(1, min(SEEDS_PER_BLOCK, s))
    while seeds > 1 and seeds * seed_bytes > SMEM_MAX:
        seeds -= 1
    if seeds * seed_bytes > SMEM_MAX:
        raise ValueError(f"a {ew}x{ew} search window with {n_steps} steps needs {seed_bytes} "
                         f"bytes of shared memory, more than {SMEM_MAX}")
    return seeds, GROUP * seeds, seeds * seed_bytes


def _box_sums(x: torch.Tensor, k: int) -> torch.Tensor:
    """VALID k×k box sum of (S, E, E) → (S, E-k+1, E-k+1): shifted adds along
    the row, then along the column."""
    out_w = x.shape[-1] - k + 1
    acc = x[:, :, 0:out_w]
    for dx in range(1, k):
        acc = acc + x[:, :, dx:dx + out_w]
    acc2 = acc[:, 0:out_w, :]
    for dy in range(1, k):
        acc2 = acc2 + acc[:, dy:dy + out_w, :]
    return acc2


def _shifted_corr(windows: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Per-seed valid correlation (S, E, E) ⊛ (S, k, k) → (S, E-k+1, E-k+1)
    as k² shifted multiply-adds, template rows outermost."""
    k = kernels.shape[-1]
    out_w = windows.shape[-1] - k + 1
    acc = None
    for i in range(k):
        for j in range(k):
            term = windows[:, i:i + out_w, j:j + out_w] * kernels[:, i, j][:, None, None]
            acc = term if acc is None else acc + term
    return acc


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two long) by halving: the upper
    half is added onto the lower until one entry is left."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def zmncc_score_map(windows: torch.Tensor, ref_patch: torch.Tensor) -> torch.Tensor:
    """(S, EW-7, EW-7) zero-mean NCC of each template at every patch position
    of its window."""
    s = windows.shape[0]
    sum_t = _box_sums(windows, PATCH)
    sum_t2 = _box_sums(windows * windows, PATCH)
    corr = _shifted_corr(windows, ref_patch)
    area = float(PATCH * PATCH)
    flat = ref_patch.reshape(s, PATCH * PATCH)
    ref_mean = _tree_sum(flat) / area
    ref_zm = flat - ref_mean[:, None]
    ref_den = _tree_sum(ref_zm * ref_zm)
    num = corr - ref_mean[:, None, None] * sum_t
    var_t = torch.clamp_min(sum_t2 - sum_t * sum_t / area, 0.0)
    return num / (torch.sqrt(ref_den[:, None, None] * var_t) + 1e-12)


def zmncc_line_scores_plain(windows, ref_patch, su0, sv0, dir_u, dir_v, n_line,
                            au, av, hs, ws, n_steps: int):
    """Returns (score_best (S,), score_second (S,), k_best (S,) int32).
    ``su0/sv0`` are the line start in score-map coordinates (start − 4 −
    anchor); the bounds use the level image dims (hs, ws).  Rows whose every
    step is masked give (−inf, −inf, 0)."""
    dev = windows.device
    f32 = torch.float32
    zmncc = zmncc_score_map(windows.to(f32), ref_patch.to(f32))
    cw = zmncc.shape[-1]

    ks = torch.arange(n_steps, dtype=f32, device=dev)
    su = su0[:, None] + dir_u[:, None] * ks[None, :]                 # (S, K)
    sv = sv0[:, None] + dir_v[:, None] * ks[None, :]
    y = torch.arange(cw, dtype=f32, device=dev)
    wy = torch.clamp_min(1.0 - torch.abs(sv[..., None] - y), 0.0)    # (S, K, CW)
    wx = torch.clamp_min(1.0 - torch.abs(su[..., None] - y), 0.0)
    # dense form: every map entry times its weight (a non-finite entry
    # therefore reaches every step of its seed)
    rows = torch.matmul(wy, zmncc)                                   # (S, K, CW)
    scores = torch.sum(wx * rows, dim=-1)

    pu = su + 4.0 + au[:, None].to(f32)
    pv = sv + 4.0 + av[:, None].to(f32)
    hf = hs[:, None].to(f32)
    wf = ws[:, None].to(f32)
    k_mask = ((ks[None, :] <= n_line[:, None].to(f32))
              & (su >= 0.0) & (su <= cw - 1.0) & (sv >= 0.0) & (sv <= cw - 1.0)
              # the full patch must also lie inside the image, not just the window
              & (pu - 4.0 >= 0.0) & (pu + 4.0 <= wf - 1.0)
              & (pv - 4.0 >= 0.0) & (pv + 4.0 <= hf - 1.0))
    neg_inf = torch.full_like(scores, float("-inf"))
    scores = torch.where(k_mask, scores, neg_inf)

    score_best = torch.max(scores, dim=-1).values
    # first hit: the smallest step whose score reaches the best (a NaN best
    # reaches nothing; its row is not finite and is gated out by the caller)
    hit = scores >= score_best[:, None]
    k_all = torch.arange(n_steps, dtype=torch.int64, device=dev)
    k_best = torch.min(torch.where(hit, k_all[None, :], torch.full_like(k_all, n_steps)[None, :]),
                       dim=-1).values
    is_nan = torch.isnan(scores)
    k_nan = torch.min(torch.where(is_nan, k_all[None, :],
                                  torch.full_like(k_all, n_steps)[None, :]), dim=-1).values
    k_best = torch.where(k_nan < n_steps, k_nan, k_best).clamp(0, n_steps - 1)
    far = torch.abs(k_all[None, :] - k_best[:, None]) > 1
    score_second = torch.max(torch.where(far, scores, neg_inf), dim=-1).values
    score_second = torch.where(torch.isnan(score_best), score_best, score_second)
    return score_best, score_second, k_best.to(torch.int32)


def zmncc_line_scores_prepare(windows, ref_patch, su0, sv0, dir_u, dir_v, n_line,
                              au, av, hs, ws, n_steps: int):
    """Check the tensors and prepare one launch of K6: returns ``(launch,
    out)`` with ``out = (score_best, score_second, k_best)``.  ``launch()``
    enqueues ``hso_zmncc_line_scores`` on the stream that was current here
    and adds one to the count (nothing is enqueued for S = 0); a timing loop
    calls it again and again without the wrapper's tensor work."""
    from hso_tpu_torch import _cuda_build

    _want = _cuda_build.check_tensor
    dev = windows.device
    s, ew = windows.shape[0], windows.shape[-1]
    if ew < PATCH or n_steps < 1:
        raise ValueError(f"window edge {ew} / n_steps {n_steps} out of range")
    _want(windows, torch.float32, (s, ew, ew), dev, "windows")
    _want(ref_patch, torch.float32, (s, PATCH, PATCH), dev, "ref_patch")
    for name, t in (("su0", su0), ("sv0", sv0), ("dir_u", dir_u), ("dir_v", dir_v)):
        _want(t, torch.float32, (s,), dev, name)
    for name, t in (("n_line", n_line), ("au", au), ("av", av), ("hs", hs), ("ws", ws)):
        _want(t, torch.int32, (s,), dev, name)
    zmncc_launch_plan(s, ew, n_steps)                 # raises beyond shared memory
    scores = torch.empty((2, s), dtype=torch.float32, device=dev)
    k_best = torch.empty((s,), dtype=torch.int32, device=dev)
    out = (scores[0], scores[1], k_best)
    if s == 0:
        return (lambda: None), out
    fn = _cuda_build.lib().hso_zmncc_line_scores
    # the tuple keeps every tensor the kernel reads alive as long as `launch`
    alive = (windows, ref_patch, su0, sv0, dir_u, dir_v, n_line, au, av, hs, ws, scores, k_best)
    args = tuple(t.data_ptr() for t in alive[:11]) + (
        s, ew, n_steps, scores[0].data_ptr(), scores[1].data_ptr(), k_best.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)

    def launch(_alive=alive):
        _cuda_build.check(fn(*args), "hso_zmncc_line_scores")
        LAUNCHES["zmncc_line_scores"] += 1

    return launch, out


def zmncc_line_scores_cuda(windows, ref_patch, su0, sv0, dir_u, dir_v, n_line,
                           au, av, hs, ws, n_steps: int):
    """K6: launch ``hso_zmncc_line_scores`` on the current stream (a group of
    ``GROUP`` threads per seed, ``zmncc_launch_plan`` seeds per block)."""
    launch, out = zmncc_line_scores_prepare(windows, ref_patch, su0, sv0, dir_u, dir_v, n_line,
                                            au, av, hs, ws, n_steps)
    launch()
    return out


def zmncc_line_scores(windows, ref_patch, su0, sv0, dir_u, dir_v, n_line,
                      au, av, hs, ws, n_steps: int):
    """Best / second-best ZMNCC score and best step along every seed's
    epipolar segment."""
    if windows.is_cuda:
        c = torch.Tensor.contiguous
        return zmncc_line_scores_cuda(c(windows), c(ref_patch), c(su0), c(sv0), c(dir_u),
                                      c(dir_v), c(n_line), c(au), c(av), c(hs), c(ws), n_steps)
    return zmncc_line_scores_plain(windows, ref_patch, su0, sv0, dir_u, dir_v, n_line,
                                   au, av, hs, ws, n_steps)
