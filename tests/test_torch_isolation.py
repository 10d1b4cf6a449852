"""The PyTorch port stands alone: no jax, no fennec_tpu.

The machine with the card has no JAX, so importing fennec_tpu_torch must
not import jax or the JAX package (whose __init__ imports jax), now or
after later changes.
"""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "fennec_tpu_torch"
# An import statement naming jax or fennec_tpu (not fennec_tpu_torch).
# The path string "fennec_tpu/native/entropy.cpp" in native.py is a file
# the port compiles, not an import.
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|fennec_tpu)\b(?!_torch)"
    r"|from\s+(jax|fennec_tpu)\b(?!_torch)[\w.]*\s+import)", re.M)


def test_import_leaves_jax_out():
    code = ("import sys, fennec_tpu_torch, fennec_tpu_torch.engine.compress,"
            " fennec_tpu_torch.ops.ssim_cuda, fennec_tpu_torch.batch,"
            " fennec_tpu_torch.engine.batched, fennec_tpu_torch.cli,"
            " fennec_tpu_torch.parallel.batched,"
            " fennec_tpu_torch.codecs.progressive, fennec_tpu_torch.analyze,"
            " fennec_tpu_torch.engine.targetsize,"
            " fennec_tpu_torch.engine.targetsize_batched,"
            " fennec_tpu_torch.engine.size_search,"
            " fennec_tpu_torch.ops.jpeg_size, fennec_tpu_torch.ops.quantize,"
            " fennec_tpu_torch.ops.jpeg_emit,"
            " fennec_tpu_torch.ops.jpeg_emit_cuda,"
            " fennec_tpu_torch.ops.huffbuild,"
            " fennec_tpu_torch.ops.huffbuild_cuda,"
            " fennec_tpu_torch.ops.probe_recon_cuda,"
            " fennec_tpu_torch.ops.effects, fennec_tpu_torch.io,"
            " fennec_tpu_torch.parallel, fennec_tpu_torch.parallel.mesh,"
            " fennec_tpu_torch.parallel.distributed,"
            " fennec_tpu_torch.utils, fennec_tpu_torch.utils.profiling; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'fennec_tpu' "
            "or m.startswith('fennec_tpu.')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_no_jax_import_in_source(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


def test_guard_pattern_catches_imports():
    for line in ("import jax", "import jax.numpy as jnp",
                 "from jax import lax", "from fennec_tpu.ops import dct",
                 "import fennec_tpu", "    from fennec_tpu import native"):
        assert FORBIDDEN.search(line), line
    for line in ("import fennec_tpu_torch", "from fennec_tpu_torch import x",
                 'SOURCE = "fennec_tpu/native/entropy.cpp"'):
        assert not FORBIDDEN.search(line), line
