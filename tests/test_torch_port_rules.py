"""Rules of the port package, checked from its source and on the CPU.

No module of the port, and not chip_smoke.py, imports JAX, Flax, Optax,
Orbax or the JAX package. This reads the import statements (AST); a
sys.modules check cannot work here, because the interpreter may import jax
at start-up before any test runs. Entry points never drop to the CPU, and
the kernel build (ops/_build.py) is driven here with a stand-in nvcc.
"""

import ast
import os
import stat

import pytest
import torch

from group_attribution_for_diffusion_models_tpu_torch.ops import _build
from group_attribution_for_diffusion_models_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "group_attribution_for_diffusion_models_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax",
             "group_attribution_for_diffusion_models_tpu"}


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 15
    bad = {
        os.path.relpath(f, REPO): sorted(set(_imported_roots(f)) & FORBIDDEN)
        for f in files
    }
    assert {f: m for f, m in bad.items() if m} == {}


# The text-to-image scoring slice's modules: each is among the files checked.
SCORING_SLICE = [
    "utils/image_metrics.py", "models/clip_vision.py", "cli/compute_model_behaviors.py",
    "cli/_tti_lds.py", "cli/shapley_lds.py", "cli/banzhaf_lds.py", "cli/loo_lds.py",
    "cli/aoi_lds.py", "cli/shapley_convergence.py", "cli/baseline_lds.py",
    "cli/grad_features_tti.py", "attributions/methods/similarity.py",
    "cli/similarity_baselines.py",
]


# The single-model jobs' slice: cli.main, WoodFisher unlearning and its CLI,
# and the CLIs that read their rows.
SINGLE_MODEL_SLICE = [
    "cli/main.py", "unlearn/__init__.py", "unlearn/woodfisher.py", "cli/unlearn.py",
    "cli/attribute.py", "cli/empirical_verification.py", "cli/shapley_groundtruth.py",
]


@pytest.mark.parametrize("module", SCORING_SLICE + SINGLE_MODEL_SLICE)
def test_scoring_slice_modules_import_no_jax(module):
    path = os.path.join(PORT, module)
    assert path in _port_files()
    assert not set(_imported_roots(path)) & FORBIDDEN


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu").type == "cpu"


def _fake_csrc(monkeypatch, tmp_path, sources):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name, text in sources.items():
        (csrc / f"{name}.cu").write_text(text)
    monkeypatch.setattr(_build, "_CSRC", str(csrc))
    monkeypatch.setattr(_build, "_BUILD_DIR", str(csrc / "build"))
    return csrc


def _fake_nvcc(monkeypatch, tmp_path):
    """An `nvcc` on PATH that copies its source to the -o file, and fails on a
    source that says FAIL."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'out=""; src=""\n'
        'while [ $# -gt 0 ]; do\n'
        '  case "$1" in -o) out="$2"; shift 2;; *.cu) src="$1"; shift;; *) shift;; esac\n'
        "done\n"
        'if grep -q FAIL "$src"; then echo "error: bad kernel"; exit 1; fi\n'
        'cp "$src" "$out"\n'
    )
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")


def test_build_compiles_each_source_once_and_rebuilds_on_change(monkeypatch, tmp_path):
    a_text = '#include "common.cuh"\n// a'
    csrc = _fake_csrc(monkeypatch, tmp_path, {"a": a_text, "b": "// b"})
    (csrc / "common.cuh").write_text('#include "inner.cuh"\n// shared')
    (csrc / "inner.cuh").write_text("// inner")
    _fake_nvcc(monkeypatch, tmp_path)
    paths = _build.build(["a", "b"])
    assert sorted(paths) == ["a", "b"]
    assert open(paths["a"]).read() == a_text
    assert sorted(os.listdir(csrc / "build")) == sorted(os.path.basename(p) for p in paths.values())
    # Unchanged sources are not rebuilt: no compiler is needed to find them.
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    assert _build.build(["a", "b"]) == paths
    # An edited header, included directly or through another, rebuilds every
    # source that includes it, and no other.
    for header in ("inner.cuh", "common.cuh"):
        before = _build.library_path("a")
        (csrc / header).write_text(f"// {header}, edited")
        assert _build.library_path("a") != before
        assert _build.library_path("b") == paths["b"]
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build(["a"])
    (csrc / "a.cu").write_text("// a, edited")
    assert _build.library_path("a") != paths["a"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["a"])


def test_build_reports_compiler_errors(monkeypatch, tmp_path):
    _fake_csrc(monkeypatch, tmp_path, {"good": "// ok", "bad": "// FAIL"})
    _fake_nvcc(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="nvcc bad.cu exited 1:\nerror: bad kernel"):
        _build.build(["good", "bad"])
    assert os.path.exists(_build.library_path("good"))
    assert not os.path.exists(_build.library_path("bad"))
