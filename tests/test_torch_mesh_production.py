"""The port's production batch engines on a mesh, on the CPU; case for
case against tests/test_mesh_production.py.

Given a sequence of devices, compress_images / compress_batch split every
chunk's rows over it (parallel/batched.shard_data_call): here
["cpu"] * n, each entry a shard in a thread of its own.  Results must be
byte-identical to one device's on 1 to 4 shards, tails included; the
one-device route is held to the JAX engines by tests/test_torch_batch.py.
The fault cases replace the chunk's device function, as
tests/test_torch_batch.py does on one device.
"""

import threading
import warnings

import numpy as np
import pytest
import torch

import fennec_tpu_torch as T
from conftest import make_noise_image, make_test_image
from fennec_tpu.codecs.jpeg import encode_jpeg
from fennec_tpu_torch.engine import batched as tbatched
from fennec_tpu_torch.parallel import batched as tpb
from test_torch_batch import oom_when_larger_than, photo, write_files

torch.set_num_threads(1)

CPU = "cpu"
SHARDS = [1, 2, 3, 4]


def mesh(n):
    return [CPU] * n


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    monkeypatch.delenv("FENNEC_MESH", raising=False)
    tbatched.counters.reset()


def _photo_images(n, w=80, h=96):
    """tests/test_mesh_production.py's images."""
    rng = np.random.default_rng(7)
    imgs = []
    for _ in range(n):
        im = np.clip(rng.normal(128, 40, (h, w, 4)), 0, 255).astype(
            np.uint8)
        im[..., 3] = 255
        imgs.append(im)
    return imgs


def same_bytes(a, b):
    assert [r.compressed_data for r in a] == [r.compressed_data for r in b]
    assert [r.jpeg_quality for r in a] == [r.jpeg_quality for r in b]
    assert [r.ssim for r in a] == [r.ssim for r in b]


class TestDataMesh:
    def test_disabled_by_default_on_cpu(self):
        assert tpb.data_mesh() is None

    def test_forced_on_has_no_virtual_devices(self, monkeypatch):
        # The JAX package's FENNEC_MESH=1 shards over its CPU backend's
        # virtual devices; PyTorch has none, so it adds nothing here.
        monkeypatch.setenv("FENNEC_MESH", "1")
        assert tpb.data_mesh() is None

    def test_disable_flag_wins(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
        assert tpb.data_mesh().size == 8
        monkeypatch.setenv("FENNEC_MESH", "0")
        assert tpb.data_mesh() is None


class TestPixelPathMesh:
    @pytest.mark.parametrize("n", SHARDS)
    @pytest.mark.parametrize("device_entropy", [True, False])
    def test_same_bytes_as_one_device(self, n, device_entropy):
        imgs = _photo_images(10)
        opts = T.Options(format=T.JPEG, device_entropy=device_entropy)
        base = T.compress_images(None, imgs, opts, device=CPU)
        sharded = T.compress_images(None, imgs, opts, device=mesh(n))
        same_bytes(base, sharded)

    def test_tail_smaller_than_mesh(self):
        # 3 images < 4 shards: one shard stays empty.
        imgs = _photo_images(3)
        opts = T.Options(format=T.JPEG)
        base = T.compress_images(None, imgs, opts, device=CPU)
        rs = T.compress_images(None, imgs, opts, device=mesh(4))
        assert all(r.compressed_size > 0 for r in rs)
        same_bytes(base, rs)

    def test_chunks_and_tail_over_the_mesh(self):
        imgs = _photo_images(11, 48, 40)
        opts = T.Options(format=T.JPEG)
        base = tbatched.compress_images_batched(None, imgs, opts,
                                                device=CPU, chunk_size=4)
        tbatched.counters.reset()
        got = tbatched.compress_images_batched(None, imgs, opts,
                                               device=mesh(3), chunk_size=4)
        assert tbatched.counters.snapshot()["chunk_items"] == [4, 4, 3]
        same_bytes(base, got)

    def test_chunk_is_mesh_size_times_a_shards(self, monkeypatch):
        monkeypatch.setattr(tbatched, "MAX_CHUNK", 2)
        imgs = _photo_images(7, 32, 32)
        opts = T.Options(format=T.JPEG)
        base = T.compress_images(None, imgs, opts, device=CPU)
        tbatched.counters.reset()
        got = T.compress_images(None, imgs, opts, device=mesh(3))
        assert tbatched.counters.snapshot()["chunk_items"] == [6, 1]
        same_bytes(base, got)


class TestCoefPathMesh:
    """The coefficient path (compress_batch's JPEG→JPEG route) on a mesh:
    every emission kind, with and without a resize."""

    @pytest.mark.parametrize("n", SHARDS)
    @pytest.mark.parametrize("device_entropy,optimize", [
        (True, True),    # two-stage device emission, optimal tables
        (True, False),   # device emission, standard tables
        (False, True),   # host Huffman
    ], ids=["opt", "emit", "host"])
    @pytest.mark.parametrize("max_width", [0, 48], ids=["full", "resize"])
    def test_smooth_identical(self, n, device_entropy, optimize, max_width):
        datas = [encode_jpeg(make_test_image(80, 96), q)
                 for q in (88, 92, 95) for _ in range(3)]
        opts = T.Options(format=T.JPEG, device_entropy=device_entropy,
                         optimize_huffman=optimize, max_width=max_width)
        base = tbatched.compress_jpeg_bytes_batched(None, datas, opts,
                                                    device=CPU)
        sharded = tbatched.compress_jpeg_bytes_batched(None, datas, opts,
                                                       device=mesh(n))
        same_bytes(base, sharded)
        if max_width:
            assert all(r.final_dimensions[0] == 48 for r in sharded)

    def test_noise_dense_identical(self):
        datas = [encode_jpeg(make_noise_image(80, 96, seed=i), 90)
                 for i in range(9)]
        opts = T.Options(format=T.JPEG, device_entropy=True)
        base = tbatched.compress_jpeg_bytes_batched(None, datas, opts,
                                                    device=CPU)
        sharded = tbatched.compress_jpeg_bytes_batched(None, datas, opts,
                                                       device=mesh(3))
        same_bytes(base, sharded)

    def test_compress_batch_entry(self, tmp_path):
        # The production entry point end to end: files in, files out,
        # over the mesh, byte-identical to one device.
        datas = [encode_jpeg(make_test_image(80, 96), 92)] * 5
        bopts = T.BatchOptions(fused=True,
                               default_opts=T.Options(format=T.JPEG))
        one = T.compress_batch(None, write_files(tmp_path, datas, tag="a"),
                               bopts, device=CPU)
        tbatched.counters.reset()
        res = T.compress_batch(None, write_files(tmp_path, datas, tag="b"),
                               bopts, device=mesh(2))
        assert all(r.err is None for r in res)
        assert tbatched.counters.snapshot()["routes"] == {"coefficient": 5}
        assert [open(r.item.dst, "rb").read() for r in res] == \
            [open(r.item.dst, "rb").read() for r in one]


class TestFaultsOnAMesh:
    def test_oom_halves_the_whole_chunk(self, monkeypatch):
        imgs = [photo(48, 48, s) for s in range(5)]
        opts = T.Options(format=T.JPEG)
        want = T.compress_images(None, imgs, opts, device=CPU)
        fn, sizes = oom_when_larger_than(
            tbatched.batched_quality_search_quantize, 2)
        monkeypatch.setattr(tbatched, "batched_quality_search_quantize", fn)
        tbatched.counters.reset()
        got = T.compress_images(None, imgs, opts, device=mesh(2))
        # 5 rows: shards of 3 (out of memory) and 2; then the halves, 2
        # rows (1 + 1) and 3 rows (2 + 1).
        assert sorted(sizes) == [1, 1, 1, 2, 2, 3]
        assert tbatched.counters.snapshot()["chunk_items"] == [2, 3]
        same_bytes(want, got)

    def test_oom_of_one_image_fails_only_it(self, monkeypatch):
        fn, _ = oom_when_larger_than(
            tbatched.batched_quality_search_quantize, 0)
        monkeypatch.setattr(tbatched, "batched_quality_search_quantize", fn)
        errors = {}
        with pytest.raises(tbatched.FusedChunkError) as exc_info:
            tbatched.compress_images_batched(
                None, [photo(32, 32, 1), photo(32, 32, 2)],
                T.Options(format=T.JPEG), device=mesh(2),
                on_error=errors.__setitem__)
        assert sorted(errors) == [0, 1] and not exc_info.value.wedged
        assert all(isinstance(e, torch.cuda.OutOfMemoryError)
                   for e in errors.values())

    def test_cuda_error_on_one_shard_wedges_the_batch(self, tmp_path,
                                                      monkeypatch):
        """The second chunk's first shard call hits a sticky CUDA error:
        the first chunk's items are on disk, every other item fails with
        that error, the device is never called again, and nothing goes
        to the per-file pool."""
        import fennec_tpu_torch.parallel.batched as pb

        real = pb.batched_decode_resize_search_quantize
        calls = []
        lock = threading.Lock()

        def fn(*args):
            with lock:
                calls.append(args[0].shape[0])
                bad = len(calls) == 3
            if bad:
                raise torch.AcceleratorError(
                    "CUDA error: an illegal memory access was encountered")
            return real(*args)

        monkeypatch.setattr(tbatched, "MAX_CHUNK", 2)
        monkeypatch.setattr(pb, "batched_decode_resize_search_quantize", fn)
        datas = [encode_jpeg(photo(48, 48, i), 92) for i in range(7)]
        items = write_files(tmp_path, datas)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            res = T.compress_batch(None, items, T.BatchOptions(
                fused=True, default_opts=T.Options(format=T.JPEG)),
                device=mesh(2))
        # Chunks of 4 (2 + 2) and 3 (2 + 1): both shards of the second
        # chunk ran, one failed, and nothing ran after it.
        assert sorted(calls) == [1, 2, 2, 2]
        assert any("device unusable" in str(x.message) for x in w)
        assert [r.err is None for r in res] == [True] * 4 + [False] * 3
        assert all("illegal memory access" in str(r.err) for r in res[4:])
        assert "pool" not in tbatched.counters.snapshot()["routes"]


class TestTargetSizeMesh:
    def test_buckets_match_one_device(self):
        # Target-size buckets run on the mesh's first device (the JAX
        # target-size engine has no mesh): the same bytes.
        imgs = [photo(64, 64, s) for s in range(3)]
        opts = T.Options(format=T.JPEG, target_size=2500)
        base = T.compress_images(None, imgs, opts, device=CPU)
        got = T.compress_images(None, imgs, opts, device=mesh(2))
        same_bytes(base, got)
