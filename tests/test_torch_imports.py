"""The port imports torch, never JAX and nothing of the JAX package; its
kernel modules import without a compiler or a GPU (the build is at first
launch)."""

import ctypes
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import hso_tpu_torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = sorted(m.name for m in pkgutil.walk_packages(hso_tpu_torch.__path__, "hso_tpu_torch."))


def test_module_list_is_complete():
    for name in ("hso_tpu_torch._cuda_build", "hso_tpu_torch.ops.window_cuda",
                 "hso_tpu_torch.ops.align_cuda", "hso_tpu_torch.track.coarse_cuda",
                 "hso_tpu_torch.track.pose_cuda", "hso_tpu_torch.pipeline.fused_step",
                 "hso_tpu_torch.utils.checkpoint", "hso_tpu_torch.testing",
                 "hso_tpu_torch.ops.epipolar", "hso_tpu_torch.ops.epipolar_cuda",
                 "hso_tpu_torch.mapping", "hso_tpu_torch.mapping.depth_filter",
                 "hso_tpu_torch.image.interp", "hso_tpu_torch.tools.profile_track",
                 "hso_tpu_torch.ops.detect", "hso_tpu_torch.ba", "hso_tpu_torch.ba.local_ba",
                 "hso_tpu_torch.pipeline.keyframe", "hso_tpu_torch.pipeline.scan",
                 "hso_tpu_torch.bench", "hso_tpu_torch.tools.reused_rows",
                 "hso_tpu_torch.mapmodel", "hso_tpu_torch.mapmodel.structures",
                 "hso_tpu_torch.math.epipolar_geometry", "hso_tpu_torch.ops.klt",
                 "hso_tpu_torch.pipeline.ba_glue", "hso_tpu_torch.pipeline.frame_handler",
                 "hso_tpu_torch.io", "hso_tpu_torch.io.calib", "hso_tpu_torch.io.image_reader",
                 "hso_tpu_torch.io.trajectory", "hso_tpu_torch.utils.trace",
                 "hso_tpu_torch.photometric", "hso_tpu_torch.photometric.online_calib",
                 "hso_tpu_torch.run_dataset", "hso_tpu_torch.tools.make_synthetic_dataset",
                 "hso_tpu_torch.tools.boxseq_multirun", "hso_tpu_torch.io.native_reader",
                 "hso_tpu_torch.utils.live_view", "hso_tpu_torch.ba.distributed",
                 "hso_tpu_torch.tools.multiproc_ba", "hso_tpu_torch.tools.host_loops",
                 "hso_tpu_torch.pipeline.kf_map"):
        assert name in MODULES


@pytest.mark.parametrize("module", ["pipeline/keyframe.py", "ba/local_ba.py", "ops/detect.py",
                                    "pipeline/scan.py", "pipeline/kf_map.py"])
def test_keyframe_path_has_no_host_sync(module):
    """The keyframe body and what it calls never wait on the device: no
    ``.item()``, ``.tolist()``, ``nonzero``, ``bool(``/``int(``/``float(`` of a
    tensor, and no tensor made from host data on the device."""
    import re

    with open(os.path.join(ROOT, "hso_tpu_torch", module)) as fh:
        code = "\n".join(line.split("#")[0] for line in fh.read().splitlines())
    body = code[code.index('"""', code.index('"""') + 3) + 3:]        # past the docstring
    for pat in (r"\.item\(", r"\.tolist\(", r"nonzero", r"\.cpu\(", r"\.numpy\(",
                r"new_tensor", r"torch\.tensor\(", r"as_tensor\(", r"bool\(\w+\[",
                r"float\((out|st|ba|stats)\b"):
        assert not re.search(pat, body), (module, pat)


def test_frame_handler_defaults_to_the_card():
    """``FrameHandler`` runs on the card unless the caller asks for the CPU."""
    import inspect

    from hso_tpu_torch.pipeline.frame_handler import FrameHandler

    assert inspect.signature(FrameHandler).parameters["device"].default == "cuda"


def test_bench_refuses_to_run_without_a_card():
    """``python -m hso_tpu_torch.bench`` never falls back to the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "-m", "hso_tpu_torch.bench"], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 2 and res.stdout == ""
    assert "--device cpu" in res.stderr


def test_reused_rows_tool_refuses_to_run_without_a_card():
    """The diagnostic of reused activation rows asks for ``--device cpu``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "-m", "hso_tpu_torch.tools.reused_rows"], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 2 and res.stdout == ""
    assert "--device cpu" in res.stderr


def test_host_loops_tool_refuses_to_run_without_a_card():
    """The host loops in turns never fall back to the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "-m", "hso_tpu_torch.tools.host_loops"], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 2 and res.stdout == ""
    assert "--device cpu" in res.stderr


def test_boxseq_multirun_refuses_to_run_without_a_card(tmp_path):
    """The boxseq-2200 bar never falls back to the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "-m", "hso_tpu_torch.tools.boxseq_multirun",
                          f"data={tmp_path}", f"out={tmp_path}/o.json"], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 2 and res.stdout == ""
    assert "device=cpu" in res.stderr
    assert not os.path.exists(tmp_path / "o.json")


def test_fresh_interpreter_imports_everything_without_jax():
    code = (
        "import importlib, sys\n"
        f"mods = {['hso_tpu_torch'] + MODULES!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'hso_tpu' or m.startswith('hso_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "assert 'cv2' not in sys.modules      # the image reader imports it lazily\n"
        "from hso_tpu_torch import _cuda_build\n"
        "assert _cuda_build._lib is None      # nothing was built or loaded\n"
        "print('ok', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().startswith("ok")


def test_sources_name_neither_jax_nor_the_jax_package():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|hso_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "hso_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 25
    for path in files:
        with open(path) as fh:
            assert not pat.search(fh.read()), path


def test_kernel_sources_are_in_the_package():
    from hso_tpu_torch import _cuda_build

    assert _cuda_build._sources() == ["align.cu", "coarse.cu", "epipolar.cu", "graph_cond.cu",
                                      "pose.cu", "probe.cu", "window.cu"]
    assert "hso_zmncc_line_scores" in _cuda_build._SIGNATURES
    # every kernel's entry point is in its source, and no source uses atomics
    entries = {"epipolar.cu": "hso_zmncc_line_scores", "coarse.cu": "hso_coarse_level_ic",
               "pose.cu": "hso_pose_lm", "align.cu": "hso_align_match",
               "window.cu": "hso_extract_windows", "probe.cu": "hso_probe_latency",
               "graph_cond.cu": "hso_if_node_begin"}
    for name, entry in entries.items():
        with open(os.path.join(_cuda_build.CSRC_DIR, name)) as fh:
            src = fh.read()
        assert f'extern "C" int {entry}(' in src, name
        assert "atomic" not in src.lower().replace("no atomics", "").replace(
            "no float atomics", ""), name
    assert "arch=compute_90a,code=sm_90a" in _cuda_build.NVCC_FLAGS
    # the six kernels take at least nine arguments each (pointers and the
    # stream declared one by one); K1's multi-job entry a table of jobs; the
    # plans, K3's override, the probes, the IF nodes of a captured step and the
    # node count of a capture fewer
    helpers = {"hso_coarse_launch_plan", "hso_coarse_plan_override", "hso_probe_latency",
               "hso_probe_tma", "hso_zmncc_launch_plan", "hso_align_launch_plan",
               "hso_window_launch_plan", "hso_if_node_begin", "hso_if_node_end",
               "hso_capture_counts"}
    assert helpers < set(_cuda_build._SIGNATURES)
    jobs = _cuda_build._SIGNATURES["hso_extract_windows_jobs"]
    assert jobs[0] is ctypes.POINTER(_cuda_build.WindowJob) and len(jobs) == 4
    assert all(len(sig) >= 9 for name, sig in _cuda_build._SIGNATURES.items()
               if name not in helpers | {"hso_extract_windows_jobs"})
    # eight kernel entries: K3 has a second one that takes the camera's model
    with open(os.path.join(_cuda_build.CSRC_DIR, "coarse.cu")) as fh:
        assert 'extern "C" int hso_coarse_level_ic_model(' in fh.read()
    assert len(_cuda_build._SIGNATURES) == 8 + len(helpers)
    h1 = _cuda_build._source_hash()
    assert h1 == _cuda_build._source_hash() and len(h1) == 16


def test_build_without_compiler_raises():
    """No nvcc here: asking for the library raises, nothing falls back."""
    import shutil

    from hso_tpu_torch import _cuda_build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA compiler is installed: the build would succeed")
    with pytest.raises(RuntimeError):
        _cuda_build.build()


def test_every_jax_module_has_its_counterpart():
    """Every module of the JAX package has a module of the same path in the
    port; a ``*_pallas.py`` kernel module has its CUDA wrapper
    (``*_cuda.py``) and source (``csrc/*.cu``) instead."""
    kernels = {"ops/window_pallas.py": ("ops/window_cuda.py", "window.cu"),
               "ops/align_pallas.py": ("ops/align_cuda.py", "align.cu"),
               "ops/epipolar_pallas.py": ("ops/epipolar_cuda.py", "epipolar.cu"),
               "track/coarse_pallas.py": ("track/coarse_cuda.py", "coarse.cu"),
               "track/pose_pallas.py": ("track/pose_cuda.py", "pose.cu")}
    jax_root = os.path.join(ROOT, "hso_tpu")
    port_root = os.path.join(ROOT, "hso_tpu_torch")
    missing = []
    for d, _, names in os.walk(jax_root):
        for n in names:
            if not n.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, n), jax_root)
            if rel in kernels:
                wrapper, src = kernels[rel]
                ok = (os.path.exists(os.path.join(port_root, wrapper))
                      and os.path.exists(os.path.join(port_root, "csrc", src)))
            else:
                ok = os.path.exists(os.path.join(port_root, rel))
            if not ok:
                missing.append(rel)
    assert not missing, missing


def test_no_jax_feature_is_left_unported():
    """No module of the port raises ``NotImplementedError`` for a feature the
    JAX package has."""
    for d, _, names in os.walk(os.path.join(ROOT, "hso_tpu_torch")):
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(d, n)) as fh:
                    assert "NotImplementedError" not in fh.read(), n
