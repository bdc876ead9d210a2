"""Guards of the PyTorch port: no JAX and nothing of ``repro`` in
``src/repro_torch`` or ``chip_smoke.py``; the card is the default device;
kernels are built only when launched; the build is keyed on its sources."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):           # top level and nested alike
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 20
    bad = [f"{os.path.relpath(p, ROOT)}:{line}: {mod}"
           for p in files for line, mod in _imported_modules(p)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, "\n".join(bad)


def test_engine_import_leaves_jax_out():
    code = ("import sys; import repro_torch.serving.engine, "
            "repro_torch.convert, repro_torch.kernels.ops; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_is_the_card(monkeypatch):
    from repro_torch.configs import smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.device import resolve_device
    from repro_torch.models import LM
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM.init(smoke_config("qwen3_4b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({}, smoke_config("qwen3_4b"))
    assert resolve_device("cpu").type == "cpu"


def test_kernel_modules_import_without_nvcc(monkeypatch):
    """Importing a kernel module builds nothing; asking for a kernel
    without nvcc raises a clear error instead of falling back."""
    import importlib
    from repro_torch.kernels import _build
    for name in ("gptq_gemv", "gptq_matmul", "paged_attention", "ops"):
        importlib.import_module(f"repro_torch.kernels.{name}")
    assert _build._LIBS == {}
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT / "absent")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("gptq_gemv")


def test_build_key_tracks_sources(tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    for name in ("a.cu", "common.cuh"):
        (tmp_path / name).write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    k1 = _build.build_key()
    assert _build.build_key() == k1
    (tmp_path / "common.cuh").write_text("// v2\n")
    k2 = _build.build_key()
    assert k2 != k1
    (tmp_path / "notes.txt").write_text("not a source\n")
    assert _build.build_key() == k2


def test_every_kernel_source_exists():
    from repro_torch.kernels import _build
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert "build/" in open(os.path.join(ROOT, ".gitignore")).read()


def test_cuda_wrappers_refuse_other_devices():
    from repro_torch.kernels import _build
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        _build.check_cuda_operands("k", torch.zeros(2, device="meta"))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _build.dtype_code(torch.float16)
    with pytest.raises(RuntimeError, match="error 9"):
        _build.check_launch(9, "k")
