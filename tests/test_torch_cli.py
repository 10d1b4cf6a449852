"""The PyTorch port's CLI and analyze against the JAX package's.

Both CLIs run in this process through their main(argv) on the same
files, the port's with --device cpu: single-file, --batch and --analyze
must give the same exit code, the same chosen quality (read back from
each output's quantization table) and the same analysis lines.  One run
of `python -m fennec_tpu_torch` in a subprocess shows the module entry
point works.  An unparsable --target-size and an out-of-range --ssim
exit non-zero; --device-entropy on writes the bytes --device-entropy off
writes.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from conftest import (
    make_noise_image,
    make_test_image,
    make_test_image_with_alpha,
)
import fennec_tpu as J
from fennec_tpu import cli as jcli
import fennec_tpu_torch as T
from fennec_tpu_torch import cli as tcli
from fennec_tpu_torch.codecs import jpeg as tjpeg
from fennec_tpu_torch.codecs.png import encode_png_rgba
from fennec_tpu_torch.ops.dct import all_quality_tables

REPO = pathlib.Path(__file__).resolve().parent.parent
# Luminance on exact .5 histogram boundaries: jitted XLA fuses the
# luminance sum into floor(lum + 0.5) and rounds such pixels into the
# neighbouring bin, where torch (and the JAX package's own eager
# luminance) round them up.  A few pixels move one bin: entropy moves
# by 7e-5 on the 130×70 gradient.
ENTROPY_ATOL = 1e-4


@pytest.fixture(autouse=True)
def no_jax_compile_cache(monkeypatch):
    """The JAX CLI points jax's compile cache at the user's home; keep
    this test process on the suite's cache."""
    import fennec_tpu.utils.compile_cache as cc

    monkeypatch.setattr(cc, "enable_compile_cache", lambda *a, **k: None)


def photo(w, h, seed):
    img = make_noise_image(w, h, seed=seed).astype(np.int16)
    img[..., :3] = np.clip(img[..., :3] // 3 + 90, 0, 255)
    return img.astype(np.uint8)


def quality_of(data: bytes) -> int:
    """The quality whose luma table the file's DQT carries."""
    hdr = tjpeg.parse_jpeg(data)
    luma = hdr.qtables[hdr.comps[0]["tq"]]
    hits = [q for q in range(1, 101)
            if np.array_equal(all_quality_tables()[q, 0], luma)]
    return hits[-1]


def run_both(capsys, args_jax, args_port):
    rc_j = jcli.main(args_jax)
    out_j = capsys.readouterr()
    rc_t = tcli.main(args_port + ["--device", "cpu"])
    out_t = capsys.readouterr()
    return (rc_j, out_j), (rc_t, out_t)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_in")
    (d / "a.jpg").write_bytes(J.codecs.jpeg.encode_jpeg(photo(64, 48, 1),
                                                        92))
    (d / "b.jpg").write_bytes(J.codecs.jpeg.encode_jpeg(photo(64, 48, 2),
                                                        90))
    (d / "c.png").write_bytes(encode_png_rgba(photo(48, 48, 3)))
    (d / "d.png").write_bytes(encode_png_rgba(
        make_test_image_with_alpha(40, 32)))
    return d


@pytest.mark.parametrize("name,flags", [
    ("a.jpg", []), ("c.png", ["--format", "jpeg"]),
    ("a.jpg", ["--quality", "ultra", "--max-width", "32"]),
    ("b.jpg", ["--ssim", "0.97", "--no-optimize-huffman"]),
], ids=["jpeg", "png-to-jpeg", "ultra-resize", "ssim-std-tables"])
def test_single_file_matches_jax(capsys, tmp_path, inputs, name, flags):
    src = str(inputs / name)
    out_j, out_t = str(tmp_path / "j.jpg"), str(tmp_path / "t.jpg")
    (rc_j, _), (rc_t, o_t) = run_both(capsys, flags + [src, out_j],
                                      flags + [src, out_t])
    assert rc_j == rc_t == 0
    assert "SSIM" in o_t.out
    jpg_j, jpg_t = open(out_j, "rb").read(), open(out_t, "rb").read()
    assert quality_of(jpg_t) == quality_of(jpg_j)
    assert tjpeg.parse_jpeg(jpg_t).width == tjpeg.parse_jpeg(jpg_j).width


def test_verbose_prints_the_result(capsys, tmp_path, inputs):
    rc = tcli.main(["-v", "--device", "cpu", str(inputs / "a.jpg"),
                    str(tmp_path / "v.jpg")])
    out = capsys.readouterr()
    assert rc == 0 and "Fennec Result: JPEG | Q=" in out.out
    assert "[compressing]" in out.err


def test_batch_matches_jax(capsys, tmp_path, inputs):
    (rc_j, o_j), (rc_t, o_t) = run_both(
        capsys, ["--batch", "--format", "jpeg", str(inputs),
                 str(tmp_path / "j")],
        ["--batch", "--format", "jpeg", str(inputs), str(tmp_path / "t")])
    assert rc_j == rc_t == 0
    assert "4/4 succeeded" in o_j.out and "4/4 succeeded" in o_t.out
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names == \
        ["a.jpg", "b.jpg", "c.png", "d.png"]
    for n in names:
        jpg_j = (tmp_path / "j" / n).read_bytes()
        jpg_t = (tmp_path / "t" / n).read_bytes()
        assert quality_of(jpg_t) == quality_of(jpg_j), n


def test_batch_verbose_stdout_matches_jax(capsys, tmp_path, inputs):
    """--batch -v writes to stdout what the JAX CLI writes: the summary
    line alone (the per-file ticks go to stderr), equal apart from the
    timing figures."""
    flags = ["--batch", "-v", "--format", "jpeg", str(inputs)]
    (rc_j, o_j), (rc_t, o_t) = run_both(
        capsys, flags + [str(tmp_path / "j")], flags + [str(tmp_path / "t")])
    assert rc_j == rc_t == 0

    def untimed(out):
        return [re.sub(r"\| [0-9.]+s \([0-9.]+ images/sec\)$", "| <time>",
                       ln) for ln in out.splitlines()]

    assert untimed(o_t.out) == untimed(o_j.out)
    assert len(untimed(o_t.out)) == 1 and "4/4 succeeded" in o_t.out
    assert o_t.err.count("/4]") == o_j.err.count("/4]") == 4


def test_batch_reports_a_bad_file(capsys, tmp_path, inputs):
    d = tmp_path / "in"
    d.mkdir()
    (d / "a.jpg").write_bytes((inputs / "a.jpg").read_bytes())
    (d / "z.jpg").write_bytes((inputs / "a.jpg").read_bytes()[:200])
    (rc_j, o_j), (rc_t, o_t) = run_both(
        capsys, ["--batch", str(d), str(tmp_path / "j")],
        ["--batch", str(d), str(tmp_path / "t")])
    assert rc_j == rc_t == 1
    assert "1/2 succeeded" in o_t.out and "1/2 succeeded" in o_j.out
    assert "failed:" in o_t.err and "z.jpg" in o_t.err


@pytest.mark.parametrize("name", ["a.jpg", "c.png", "d.png"])
def test_analyze_matches_jax(capsys, inputs, name):
    src = str(inputs / name)
    (rc_j, o_j), (rc_t, o_t) = run_both(capsys, ["--analyze", src],
                                        ["--analyze", src])
    assert rc_j == rc_t == 0
    assert o_t.out == o_j.out
    assert "Image Analysis" in o_t.out


@pytest.mark.parametrize("make", [
    lambda: photo(64, 48, 4), lambda: make_test_image(130, 70),
    lambda: make_test_image_with_alpha(40, 30),
    lambda: np.full((16, 16, 4), 77, np.uint8), lambda: photo(2, 2, 1),
], ids=["noise", "gradient", "alpha", "flat", "tiny"])
def test_analyze_fields_match_jax(make):
    img = make()
    want = J.analyze(img)
    got = T.analyze(img, device="cpu")
    assert (got.width, got.height) == (want.width, want.height)
    assert got.has_alpha == want.has_alpha
    assert got.is_grayscale == want.is_grayscale
    assert got.unique_colors == want.unique_colors
    assert got.entropy == pytest.approx(want.entropy, abs=ENTROPY_ATOL)
    assert got.edge_density == pytest.approx(want.edge_density, abs=1e-6)
    assert got.mean_brightness == pytest.approx(want.mean_brightness,
                                                abs=1e-3)
    assert got.contrast == pytest.approx(want.contrast, abs=1e-3)
    assert int(got.recommended_format) == int(want.recommended_format)
    assert int(got.recommended_quality) == int(want.recommended_quality)
    assert got.estimated_compression == pytest.approx(
        want.estimated_compression)


@pytest.mark.parametrize("flags,msg", [
    (["--target-size", "4XB"], "invalid size '4XB'"),
    (["--device-entropy", "on"], None),
    (["--ssim", "1.5"], "--ssim must be in"),
], ids=["target-size", "device-entropy", "bad-ssim"])
def test_refused_flags(capsys, tmp_path, inputs, flags, msg):
    """Flags the CLI refuses (exit 1, the message on stderr), in single
    and batch mode; msg None marks a flag it once refused and now takes:
    --device-entropy on writes the bytes --device-entropy off writes."""
    for extra in ([], ["--batch"]):
        src = str(inputs) if extra else str(inputs / "a.jpg")
        out = tmp_path / ("batch" if extra else "one.jpg")
        rc = tcli.main(extra + flags + ["--device", "cpu", src, str(out)])
        err = capsys.readouterr().err
        if msg is not None:
            assert rc == 1 and msg in err
            continue
        ref = tmp_path / ("ref_batch" if extra else "ref.jpg")
        assert tcli.main(extra + ["--device-entropy", "off", "--device",
                                  "cpu", src, str(ref)]) == rc
        if extra:
            names = sorted(p.name for p in ref.iterdir())
            assert names and names == sorted(p.name for p in out.iterdir())
            for name in names:
                assert (out / name).read_bytes() == (ref / name).read_bytes()
        else:
            assert rc == 0 and out.read_bytes() == ref.read_bytes()


def test_missing_input_and_directory_errors(capsys, tmp_path):
    assert tcli.main(["--device", "cpu", str(tmp_path / "none.png"),
                      str(tmp_path / "o.jpg")]) == 1
    assert "Error" in capsys.readouterr().err
    assert tcli.main(["--batch", "--device", "cpu", str(tmp_path / "nope"),
                      str(tmp_path / "o")]) == 1
    assert tcli.main(["--analyze", "--device", "cpu",
                      str(tmp_path / "none.png")]) == 1


@pytest.mark.parametrize("fn,arg", [
    ("parse_size", "1.5MB"), ("parse_size", "100kb"), ("parse_size", "0"),
    ("parse_quality", "MAX"), ("parse_quality", "junk"),
    ("parse_format", "jpg"), ("parse_format", "whatever"),
    ("default_output", "a/b/photo.jpeg"), ("default_output", "noext"),
])
def test_parsers_match_jax(fn, arg):
    assert getattr(tcli, fn)(arg) == getattr(jcli, fn)(arg)


def test_module_entry_point(tmp_path, inputs):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = tmp_path / "m.jpg"
    proc = subprocess.run(
        [sys.executable, "-m", "fennec_tpu_torch", "--device", "cpu",
         str(inputs / "a.jpg"), str(out)],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "SSIM" in proc.stdout and out.stat().st_size > 0
    assert "jax" not in proc.stderr.lower()
