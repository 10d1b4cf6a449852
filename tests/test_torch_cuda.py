"""Kernel K1 and the main path on a CUDA card (skipped without one).

This file imports neither jax nor tests/conftest.py (which imports jax),
so it runs on the machine with the card, where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q -o addopts= --noconftest

K1 is held to its plain PyTorch version on the same card within 1e-5,
the bound the JAX package holds its Pallas kernel to.
"""

import functools

import numpy as np
import pytest
import torch

import fennec_tpu_torch as T
from fennec_tpu_torch.ops.ssim import batched_ssim_plain
from fennec_tpu_torch.ops.ssim_cuda import ssim_window

pytestmark = pytest.mark.requires_cuda

ATOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def noise_pair(shape, seed, device):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 255, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 12, shape), 0, 255).astype(np.float32)
    return (torch.from_numpy(a).to(device), torch.from_numpy(b).to(device))


# The main path's shapes and ragged ones: one window position, a strip
# of output columns or a band of rows cut short, edges past 4K.
@pytest.mark.parametrize("shape", [(3, 32, 32), (3, 64, 48), (3, 130, 100),
                                   (1, 384, 512), (4, 288, 512),
                                   (2, 9, 300), (1, 9, 9), (1, 1000, 9),
                                   (3, 137, 261), (1, 2161, 3839),
                                   (64, 500, 500), (5, 499, 499)])
def test_kernel_matches_plain(cuda_device, shape):
    a, b = noise_pair(shape, sum(shape), cuda_device)
    before = ssim_window.launches
    got = ssim_window(a, b)
    ones = ssim_window(a, a.clone())
    again = ssim_window(a, b)
    torch.cuda.synchronize()
    assert ssim_window.launches == before + 3
    torch.testing.assert_close(got, batched_ssim_plain(a, b), atol=ATOL,
                               rtol=0)
    torch.testing.assert_close(ones, torch.ones_like(ones), atol=ATOL,
                               rtol=0)
    assert torch.equal(got, again)


def test_image_scores_the_same_alone_and_in_a_batch(cuda_device):
    """The batch engines hold batch results to per-image ones bit for
    bit: an image's partial sums follow its rows, not the launch plan."""
    a, b = noise_pair((64, 500, 500), 17, cuda_device)
    batch = ssim_window(a, b)
    for i in (0, 31, 63):
        assert torch.equal(batch[i:i + 1],
                           ssim_window(a[i:i + 1].contiguous(),
                                       b[i:i + 1].contiguous()))


def test_kernel_on_a_side_stream(cuda_device):
    a, b = noise_pair((4, 288, 512), 21, cuda_device)
    want = ssim_window(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = ssim_window(a, b)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_concurrent_calls_share_no_scratch(cuda_device):
    """Two threads launch at once, each on its own stream, as the batch
    engines' workers do: each result equals a sequential call's."""
    import threading

    pairs = [noise_pair((16, 500, 500), 30 + i, cuda_device)
             for i in range(2)]
    want = [ssim_window(a, b) for a, b in pairs]
    torch.cuda.synchronize()
    got = [[] for _ in pairs]
    start = threading.Barrier(len(pairs))

    def work(i):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            start.wait()
            for _ in range(20):
                got[i].append(ssim_window(*pairs[i]))
        stream.synchronize()

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(pairs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    torch.cuda.synchronize()
    for i in range(len(pairs)):
        assert len(got[i]) == 20
        assert all(torch.equal(g, want[i]) for g in got[i])


def test_kernel_is_deterministic(cuda_device):
    a, b = noise_pair((2, 1080, 1920), 7, cuda_device)
    first = ssim_window(a, b)
    assert all(torch.equal(first, ssim_window(a, b)) for _ in range(5))


def test_kernel_rejects_bad_inputs_on_card(cuda_device):
    a, b = noise_pair((1, 40, 40), 1, cuda_device)
    with pytest.raises(TypeError):
        ssim_window(a.half(), b.half())
    with pytest.raises(ValueError):
        ssim_window(a[:, :8], b[:, :8])


def test_main_path_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(3)
    img = np.full((240, 320, 4), 255, np.uint8)
    img[..., :3] = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
    before = ssim_window.launches
    r_gpu = T.compress_image(None, img, T.Options(), device=cuda_device)
    assert ssim_window.launches == before + 7
    r_cpu = T.compress_image(None, img, T.Options(), device="cpu")
    assert r_gpu.format == r_cpu.format == T.JPEG
    assert r_gpu.jpeg_quality == r_cpu.jpeg_quality
    assert abs(r_gpu.ssim - r_cpu.ssim) <= ATOL


def test_block_transform_rows_on_card(cuda_device):
    """A block's DCT on the card is the same alone and inside a batch
    (the GEMM row padding of ops/dct.py)."""
    from fennec_tpu_torch.ops import dct

    rng = np.random.default_rng(5)
    for n in (1, 72, 3969):
        x = torch.from_numpy(rng.normal(0, 60, (8, n, 64)).astype(
            np.float32)).to(cuda_device)
        batched = dct.dct2d_blocks(x)
        assert all(torch.equal(dct.dct2d_blocks(x[i]), batched[i])
                   for i in range(8))


def test_batch_engines_on_card(cuda_device):
    from fennec_tpu_torch.engine.batched import (
        compress_jpeg_bytes_batched,
        counters,
    )

    rng = np.random.default_rng(11)
    imgs = []
    for _ in range(6):
        img = np.full((96, 128, 4), 255, np.uint8)
        img[..., :3] = rng.integers(40, 200, (96, 128, 3), dtype=np.uint8)
        imgs.append(img)
    opts = T.Options(format=T.JPEG)
    counters.reset()
    batch = T.compress_images(None, imgs, opts, device=cuda_device)
    for img, got in zip(imgs, batch):
        want = T.compress_image(None, img, opts, device=cuda_device)
        assert got.compressed_data == want.compressed_data
    datas = [T.encode_to_bytes(img, T.JPEG, 92, device=cuda_device)
             for img in imgs]
    on_card = compress_jpeg_bytes_batched(None, datas, opts,
                                          device=cuda_device)
    on_cpu = compress_jpeg_bytes_batched(None, datas, opts, device="cpu")
    for a, b in zip(on_card, on_cpu):
        assert a.jpeg_quality == b.jpeg_quality
        assert abs(a.ssim - b.ssim) <= ATOL
    assert counters.snapshot()["routes"] == {"pixel": 6, "coefficient": 12}


def photo(w, h, seed):
    """Smooth gradients with coarse noise: compressible, photo-like."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w, 4), 255, np.uint8)
    base = np.stack([255 * x / w, 255 * y / h, 128 + 60 * np.sin(x / 17)],
                    axis=-1)
    noise = np.kron(rng.normal(0, 12, (h // 8 + 1, w // 8 + 1, 3)),
                    np.ones((8, 8, 1)))[:h, :w]
    img[..., :3] = np.clip(base + noise, 0, 255).astype(np.uint8)
    return img


def test_target_size_on_card_matches_cpu(cuda_device):
    """The per-image and lockstep target-size engines give the same
    results on the card as on the CPU, and score SSIM through K1."""
    from fennec_tpu_torch.engine.targetsize import hit_target_size
    from fennec_tpu_torch.engine.targetsize_batched import (
        hit_target_size_batched,
    )

    imgs = [photo(160, 120, s) for s in range(3)]
    opts = T.Options(format=T.JPEG, target_size=1600)
    before = ssim_window.launches
    on_card = hit_target_size_batched(None, imgs, 1600, opts,
                                      device=cuda_device)
    assert ssim_window.launches > before
    for img, got in zip(imgs, on_card):
        want = hit_target_size(None, img, 1600, opts, device="cpu")
        assert (got.format, got.quality, got.final_w, got.final_h) == (
            want.format, want.quality, want.final_w, want.final_h)
        assert abs(got.ssim - want.ssim) <= 1e-4
        assert abs(len(got.data) - len(want.data)) <= 8


def test_size_oracle_and_palette_map_on_card(cuda_device):
    from fennec_tpu_torch.ops.jpeg_size import scan_bits
    from fennec_tpu_torch.ops.quantize import apply_palette, median_cut

    rng = np.random.default_rng(3)
    blocks = [rng.integers(-60, 60, (n, 64)).astype(np.float32)
              * (rng.random((n, 64)) < 0.2) for n in (48, 12, 12)]
    cpu = scan_bits(*(torch.from_numpy(b) for b in blocks), 64, 48, True)
    card = scan_bits(*(torch.from_numpy(b).to(cuda_device) for b in blocks),
                     64, 48, True)
    assert int(card) == int(cpu)
    img = photo(300, 200, 4)
    pal = median_cut(img, 64)
    np.testing.assert_array_equal(apply_palette(img, pal, cuda_device),
                                  apply_palette(img, pal, "cpu"))


# ── Kernel K3: Huffman emission ─────────────────────────────────────────────


def k3_blocks(h, w, subsample, bsz, seed):
    """(B, NT, 64) int16 sparse random blocks of h×w images, with runs of
    zeros, extreme magnitudes and all-zero blocks."""
    mult = 16 if subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    ny = (ph // 8) * (pw // 8)
    nc = (ph // 16) * (pw // 16) if subsample else ny
    rng = np.random.default_rng(seed)
    nt = ny + 2 * nc
    blocks = (rng.integers(-300, 300, (bsz, nt, 64))
              * (rng.random((bsz, nt, 64)) < 0.12))
    blocks[:, :, 0] = rng.integers(-2047, 2048, (bsz, nt))
    blocks[:, ::7, 1:] = 0
    blocks[:, 1::11, 63] = -1023
    return torch.from_numpy(blocks.astype(np.int16)), ny, nc


def k3_seam_blocks(kind, bsz, nt, seed):
    """Blocks that cross K3's seams: "zero" (EOB only), "runs" (zero runs
    of 16 to 62: one to three ZRLs), "dense" (every coefficient nonzero:
    a segment too long for K3b's shared word buffer)."""
    rng = np.random.default_rng(seed)
    blocks = np.zeros((bsz, nt, 64), np.int64)
    if kind == "zero":
        blocks[:, 0, 0] = 37
    elif kind == "runs":
        for k, nat in enumerate((24, 33, 12, 46, 62, 63)):
            blocks[:, k::6, nat] = rng.integers(1, 900, (bsz, 1))
        blocks[:, 3::6, 63] = -1
        blocks[:, :, 0] = rng.integers(-1000, 1000, (bsz, nt))
    else:
        blocks = rng.integers(200, 1000, (bsz, nt, 64)) * rng.choice(
            [-1, 1], (bsz, nt, 64))
    return torch.from_numpy(blocks.astype(np.int16))


# Geometries: one MCU, odd sides, fewer slots than a segment of 128, one
# more than a segment (8x344 in 4:4:4 is 129 slots), 1080p and 12 MP.
@pytest.mark.parametrize("h,w,sub,bsz,kind", [
    (1, 1, True, 1, "sparse"), (9, 17, True, 3, "sparse"),
    (9, 17, False, 2, "sparse"), (400, 600, True, 2, "sparse"),
    (8, 344, False, 1, "sparse"), (16, 368, True, 5, "sparse"),
    (176, 208, True, 3, "zero"), (176, 208, True, 2, "runs"),
    (88, 120, False, 2, "runs"), (80, 96, True, 64, "sparse"),
    (128, 128, True, 2, "dense"), (1080, 1920, False, 1, "sparse"),
    (3024, 4032, True, 1, "sparse")])
def test_k3_matches_plain(cuda_device, h, w, sub, bsz, kind):
    from fennec_tpu_torch.codecs.jpeg import encode_quantized
    from fennec_tpu_torch.ops import jpeg_emit, jpeg_emit_cuda as k3
    from fennec_tpu_torch.parallel.batched import emit_scans

    host, ny, nc = k3_blocks(h, w, sub, bsz, h + w)
    if kind != "sparse":
        host = k3_seam_blocks(kind, bsz, ny + 2 * nc, h + w)
    packed = host.to(cuda_device)
    mult = 16 if sub else 8
    lay = jpeg_emit.layout_on(h + (-h) % mult, w + (-w) % mult, sub,
                              cuda_device)
    tables = jpeg_emit.std_tables_on(cuda_device)
    before = (k3.block_stats.launches, k3.deposit.launches)
    got = k3.block_stats(packed, lay, tables, True, True)
    lean = k3.block_stats(packed, lay, tables)
    want = jpeg_emit.block_stats_plain(packed, lay, tables, True, True)
    totals = want.totals.cpu()
    base = torch.cat([torch.zeros(1, dtype=torch.int64),
                      torch.cumsum((totals + 31) // 32, 0)]).to(cuda_device)
    words = k3.deposit(packed, lay, tables, base, int(base[-1]))
    want_words = jpeg_emit.deposit_plain(packed, lay, tables, base)
    torch.cuda.synchronize()
    assert (k3.block_stats.launches, k3.deposit.launches) == (
        before[0] + 2, before[1] + 1)
    assert torch.equal(got.bits, want.bits)
    assert torch.equal(got.hist, want.hist)
    assert torch.equal(got.totals, want.totals)
    assert torch.equal(lean.totals, want.totals)
    assert lean.bits is None and lean.hist is None
    assert torch.equal(words, want_words) and int(words[-1]) == 0
    if bsz == 1:  # one image may leave its word bases out
        assert torch.equal(k3.deposit(packed, lay, tables, None,
                                      int(base[-1])), want_words)
    for optimize in (False, True):
        scans = emit_scans(packed, h, w, sub, optimize)
        for j in range(bsz):
            blk = host[j].numpy().astype(np.int32)
            assert scans.jpeg(j, w, h, 50, sub) == encode_quantized(
                blk[:ny], blk[ny:ny + nc], blk[ny + nc:], w, h, 50, sub,
                optimize)


def test_k3_image_ending_on_a_word(cuda_device):
    """Images whose scans end exactly on a 32-bit word, alone and in a
    batch: no word past the image's own is touched."""
    from fennec_tpu_torch.ops import jpeg_emit, jpeg_emit_cuda as k3

    many, _ny, _nc = k3_blocks(16, 32, True, 256, 11)
    lay = jpeg_emit.layout_on(16, 32, True, cuda_device)
    tables = jpeg_emit.std_tables_on(cuda_device)
    totals = k3.block_stats(many.to(cuda_device), lay, tables).totals.cpu()
    on_word = torch.nonzero(totals % 32 == 0)[:, 0]
    assert on_word.numel() > 0
    picked = many[on_word].contiguous().to(cuda_device)
    for blocks in (picked[:1].contiguous(), picked):
        n = blocks.shape[0]
        base = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(
            totals[on_word[:n]] // 32, 0)]).to(cuda_device)
        words = k3.deposit(blocks, lay, tables, base, int(base[-1]))
        assert torch.equal(words, jpeg_emit.deposit_plain(blocks, lay,
                                                          tables, base))
        assert int(words[-1]) == 0


def test_k3_optimal_emission_is_two_launches(cuda_device, monkeypatch):
    """emit_scans launches K3a once and K3b once on either route, and
    takes no torch.cumsum between them."""
    from fennec_tpu_torch.ops import jpeg_emit_cuda as k3
    from fennec_tpu_torch.parallel.batched import emit_scans

    packed = k3_blocks(500, 500, True, 8, 5)[0].to(cuda_device)

    def refuse(*args, **kw):
        raise AssertionError("emit_scans took a cumsum on the device")

    monkeypatch.setattr(torch, "cumsum", refuse)
    for optimize in (False, True):
        before = (k3.block_stats.launches, k3.deposit.launches)
        emit_scans(packed, 500, 500, True, optimize)
        assert (k3.block_stats.launches, k3.deposit.launches) == (
            before[0] + 1, before[1] + 1)


def test_size_oracle_on_card_runs_through_k3a(cuda_device, monkeypatch):
    """scan_bytes_at and size_bisect on CUDA tensors equal the CPU's
    (plain scan_bits) on the oracle's cases, launch K4 under its own
    counts (scan_bytes_at K4's step, K3a's totals from the float32
    coefficients; size_bisect K4's bisection, one launch), and never take
    a plain version, the packed quantize or K3a over packed blocks."""
    from fennec_tpu_torch.codecs.jpeg import forward_dct
    from fennec_tpu_torch.engine import size_search
    from fennec_tpu_torch.ops import jpeg_emit
    from fennec_tpu_torch.ops import jpeg_emit_cuda as k3

    cases = []
    for sub in (True, False):
        imgs = np.stack([photo(96, 80, s) for s in range(4)])
        x = torch.from_numpy(imgs).to(torch.float32)
        mult = 16 if sub else 8
        cases.append((forward_dct(x, sub), 80 + (-80) % mult,
                      96 + (-96) % mult, sub))
    quals = torch.tensor([1, 40, 75, 100])
    want = [(size_search.scan_bytes_at(c, quals, ph, pw, sub),
             size_search.scan_bytes_at([p[2] for p in c], quals[2], ph, pw,
                                       sub),
             size_search.size_bisect(c, ph, pw, sub, torch.tensor(
                 [300, 900, 2500, 99999]), 1, 100))
            for c, ph, pw, sub in cases]

    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached the plain version or "
                             "the packed quantize")

    monkeypatch.setattr(size_search, "scan_bits", refuse)
    monkeypatch.setattr(size_search, "quantize_packed", refuse)
    monkeypatch.setattr(size_search, "quantize_at", refuse)
    monkeypatch.setattr(jpeg_emit, "quantize_packed", refuse)
    monkeypatch.setattr(k3, "block_stats_plain", refuse)
    monkeypatch.setattr(k3, "quantize_count_plain", refuse)
    monkeypatch.setattr(k3, "size_bisect_plain", refuse)
    for (c, ph, pw, sub), (w_batch, w_one, w_bisect) in zip(cases, want):
        c = [p.to(cuda_device) for p in c]
        before = (k3.quantize_count.launches, k3.block_stats.launches,
                  k3.oracle_stats.launches)
        bisections = k3.size_bisect.launches
        got = size_search.scan_bytes_at(c, quals.to(cuda_device), ph, pw,
                                        sub)
        one = size_search.scan_bytes_at([p[2] for p in c],
                                        quals[2].to(cuda_device), ph, pw,
                                        sub)
        assert got.cpu().tolist() == w_batch.tolist()
        assert one.dim() == 0 and int(one) == int(w_one)
        q, found = size_search.size_bisect(
            c, ph, pw, sub, torch.tensor([300, 900, 2500, 99999],
                                         device=cuda_device), 1, 100)
        assert q.cpu().tolist() == w_bisect[0].tolist()
        assert found.cpu().tolist() == w_bisect[1].tolist()
        assert k3.quantize_count.launches == before[0] + 2
        assert k3.size_bisect.launches == bisections + 1
        assert (k3.block_stats.launches, k3.oracle_stats.launches) == \
            before[1:]


@pytest.mark.parametrize("h,w,sub,bsz", [
    (1, 1, True, 1), (9, 17, True, 3), (9, 17, False, 2),
    (400, 600, True, 2), (8, 344, False, 1), (16, 368, True, 5),
    (80, 96, True, 64), (1080, 1920, False, 1), (3024, 4032, True, 1)])
def test_k4_matches_plain(cuda_device, h, w, sub, bsz):
    """K4 on float32 coefficients with extreme values, exact halves and
    per-image qualities: the integers its plain version and the earlier
    route (packed quantize, K3a) give."""
    from fennec_tpu_torch.engine import size_search
    from fennec_tpu_torch.ops import jpeg_emit, jpeg_emit_cuda as k3

    mult = 16 if sub else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    ny = (ph // 8) * (pw // 8)
    nc = (ph // 16) * (pw // 16) if sub else ny
    rng = np.random.default_rng(h * w + bsz)
    coefs = []
    for n in (ny, nc, nc):
        c = rng.normal(0, 30, (bsz, n, 64)) * (rng.random((bsz, n, 64)) < .3)
        c[:, :, 0] = rng.uniform(-1020, 1020, (bsz, n))
        c[:, ::5, 1:] = 0
        c[:, 1::7, 63] = -900.0
        c[:, 2::9, 5] = 0.5 * 17  # exact halves at some tables
        coefs.append(torch.from_numpy(c.astype(np.float32)).to(cuda_device))
    quals = torch.from_numpy(rng.integers(1, 101, bsz)).to(cuda_device)
    quals[0] = 100
    lay = jpeg_emit.layout_on(ph, pw, sub, cuda_device)
    std = jpeg_emit.std_tables_on(cuda_device)
    tables = size_search.quality_tables_on(cuda_device)
    before = k3.quantize_count.launches
    got = k3.quantize_count(coefs, tables, quals, lay, std)
    again = k3.quantize_count(coefs, tables, quals, lay, std)
    torch.cuda.synchronize()
    assert k3.quantize_count.launches == before + 2
    want = jpeg_emit.quantize_count_plain(coefs, tables, quals, lay, std)
    packed = jpeg_emit.quantize_packed(coefs, tables[quals])
    assert torch.equal(got, want) and torch.equal(got, again)
    assert torch.equal(got, k3.block_stats(packed, lay, std).totals)


@pytest.mark.parametrize("h,w,sub,bsz,lo,hi", [
    (1, 1, True, 1, 1, 100), (9, 17, False, 3, 1, 100),
    (400, 600, True, 2, 30, 90), (80, 96, True, 64, 10, 70),
    (80, 96, False, 5, 70, 20), (1080, 1920, True, 1, 1, 100),
    (3024, 4032, True, 1, 1, 40)])
def test_k4_bisection_equals_the_step_loop(cuda_device, h, w, sub, bsz, lo,
                                           hi):
    """K4's bisection (one launch) gives the step loop's (best_q, found)
    and table, through K4's step and through the plain step loop, at
    per-image targets (some nothing fits, some everything), one image in
    its 0-d form included; two calls equal."""
    from fennec_tpu_torch.codecs.jpeg import forward_dct
    from fennec_tpu_torch.engine import size_search
    from fennec_tpu_torch.ops import jpeg_emit_cuda as k3
    from fennec_tpu_torch.ops.jpeg_emit import bisect_steps

    imgs = np.stack([photo(w, h, s) for s in range(bsz)])
    coefs = forward_dct(torch.from_numpy(imgs).to(cuda_device)
                        .to(torch.float32), sub)
    mult = 16 if sub else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    rng = np.random.default_rng(h + w + bsz)
    target = torch.from_numpy(rng.integers(0, h * w // 2 + 400, bsz))
    target[0] = 10 ** 9
    if bsz > 1:
        target[1] = 0
    if bsz == 1:
        coefs, target = [c[0] for c in coefs], target[0]
    before = (k3.size_bisect.launches, k3.quantize_count.launches)
    q, found = size_search.size_bisect(coefs, ph, pw, sub, target, lo, hi)
    again = size_search.size_bisect(coefs, ph, pw, sub, target, lo, hi)
    torch.cuda.synchronize()
    assert (k3.size_bisect.launches, k3.quantize_count.launches) == (
        before[0] + 2, before[1])
    assert q.shape == target.shape and found.shape == target.shape
    loop = size_search.size_bisect_steps(coefs, ph, pw, sub, target, lo, hi)
    bounds = size_search._bounds(coefs, target, lo, hi)
    plain = bisect_steps(
        lambda m: size_search.scan_bits(*size_search.quantize_at(coefs, m),
                                        ph, pw, sub), *bounds,
        size_search.MAX_STEPS)
    kernel = size_search._CardOracle(coefs, ph, pw, sub).bisect(bounds)
    for want in (loop, plain):
        assert torch.equal(q, want[0]) and torch.equal(found, want[1])
        assert all(torch.equal(a, b) for a, b in zip(kernel, want))
    assert torch.equal(q, again[0]) and torch.equal(found, again[1])


def test_k4_bisection_raises_without_its_library(cuda_device, monkeypatch,
                                                 tmp_path):
    """No fallback: when the library does not build, size_bisect on CUDA
    tensors raises; it takes neither the step loop nor a plain version."""
    from fennec_tpu_torch.engine import size_search
    from fennec_tpu_torch.ops import jpeg_emit_cuda as k3

    broken = tmp_path / "broken.cu"
    broken.write_text("#error this source does not build\n")
    monkeypatch.setattr(k3, "library", k3.EmitLibrary(
        str(broken), str(tmp_path / "libbroken.so")))

    def refuse(*args, **kw):
        raise AssertionError("size_bisect fell back")

    monkeypatch.setattr(size_search, "bisect_steps", refuse)
    monkeypatch.setattr(k3, "size_bisect_plain", refuse)
    coefs = [torch.zeros(1, n, 64, device=cuda_device) for n in (4, 1, 1)]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        size_search.size_bisect(coefs, 16, 16, True, 100, 1, 100)


def test_k3_never_takes_the_plain_version(cuda_device, monkeypatch):
    """CUDA tensors launch K3 or raise: the plain versions are never
    called, and device_entropy=None on the card takes K3."""
    from fennec_tpu_torch.ops import jpeg_emit_cuda as k3

    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(k3, "block_stats_plain", refuse)
    monkeypatch.setattr(k3, "deposit_plain", refuse)
    before = (k3.block_stats.launches, k3.deposit.launches)
    img = photo(120, 90, 2)
    on_card = T.compress_image(None, img, T.Options(format=T.JPEG),
                               device=cuda_device)
    assert k3.block_stats.launches == before[0] + 1
    assert k3.deposit.launches == before[1] + 1
    host = T.compress_image(None, img, T.Options(format=T.JPEG,
                                                 device_entropy=False),
                            device=cuda_device)
    assert on_card.compressed_data == host.compressed_data


def test_k3_on_streams_and_threads(cuda_device):
    """Two threads emit at once, each on its own stream: each result
    equals a sequential call's (every call owns its buffers)."""
    import threading

    from fennec_tpu_torch.parallel.batched import emit_scans

    batches = [k3_blocks(500, 500, True, 8, 40 + i)[0].to(cuda_device)
               for i in range(2)]
    want = [emit_scans(p, 500, 500, True, True).words for p in batches]
    got = [[] for _ in batches]
    start = threading.Barrier(len(batches))

    def work(i):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            start.wait()
            for _ in range(10):
                got[i].append(emit_scans(batches[i], 500, 500, True,
                                         True).words)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for i in range(2):
        assert len(got[i]) == 10
        assert all(np.array_equal(g, want[i]) for g in got[i])


def test_surface_on_card_matches_cpu(cuda_device):
    from fennec_tpu_torch.ops import effects

    a = photo(640, 480, 5)
    b = photo(640, 480, 6)
    assert abs(T.ssim(a, b, device=cuda_device)
               - T.ssim(a, b, device="cpu")) <= ATOL
    assert abs(T.ms_ssim(a, b, device=cuda_device)
               - T.ms_ssim(a, b, device="cpu")) <= ATOL
    for name, arg in (("sharpen", 0.6), ("adaptive_sharpen", 0.5),
                      ("gaussian_blur", 1.5)):
        fn = getattr(effects, name)
        np.testing.assert_array_equal(fn(a, arg, device=cuda_device),
                                      fn(a, arg, device="cpu"))


# ── Kernel K2: the fused probe reconstruction ───────────────────────────────


def k2_inputs(w, h, sub, bsz, device, seed=0):
    from fennec_tpu_torch.engine.compress import prepare_search

    imgs = np.stack([photo(w, h, seed + k) for k in range(bsz)])
    x = torch.from_numpy(imgs).to(device).to(torch.float32)
    return prepare_search(x, sub)[0]


def k2_alone(inp, j):
    import dataclasses

    return dataclasses.replace(
        inp, cplanes=tuple(p[j:j + 1].contiguous() for p in inp.cplanes),
        lum_orig=inp.lum_orig[j:j + 1].contiguous())


# (w, h): under 8 px, ragged last blocks, a side scaled up by SSIMFast,
# box-downs with odd ratios, 1080p.
@pytest.mark.parametrize("sub", [True, False], ids=["420", "444"])
@pytest.mark.parametrize("w,h,bsz", [(1, 1, 2), (9, 17, 3), (17, 9, 1),
                                     (500, 500, 4), (499, 499, 3),
                                     (1000, 9, 1), (600, 3, 2),
                                     (700, 513, 2), (513, 700, 1),
                                     (1920, 1080, 1)])
def test_k2_matches_plain(cuda_device, w, h, bsz, sub):
    """K2 against probe_luminance_plain on the card: equal except where a
    channel lands on the other level (at most 1.0 in luminance, on few
    pixels), SSIM through K1 within 1e-5, repeatable, and an image alone
    as in its batch."""
    from fennec_tpu_torch.engine import compress as C
    from fennec_tpu_torch.ops.probe_recon_cuda import probe_recon

    inp = k2_inputs(w, h, sub, bsz, cuda_device, seed=w + h)
    q = torch.from_numpy(np.random.default_rng(w * h).integers(
        1, 101, bsz)).to(cuda_device)
    before = probe_recon.launches
    got = C.probe_luminance(inp, q)
    again = C.probe_luminance(inp, q)
    torch.cuda.synchronize()
    assert probe_recon.launches == before + 2
    want = C.probe_luminance_plain(inp, q)
    assert got.shape == want.shape == inp.lum_orig.shape
    assert got.is_contiguous() and torch.isfinite(got).all()
    diff = (got - want).abs()
    assert float(diff.max()) <= 1.0 + 1e-3
    assert int((diff != 0).sum()) <= max(1, 1e-3 * diff.numel())
    assert torch.equal(got, again)
    for j in {0, bsz - 1}:
        assert torch.equal(C.probe_luminance(k2_alone(inp, j), q[j:j + 1]),
                           got[j:j + 1])
    if min(got.shape[1:]) > 8:
        s_k = ssim_window(inp.lum_orig, got)
        s_p = ssim_window(inp.lum_orig, want.contiguous())
        assert float((s_k - s_p).abs().max()) <= ATOL


@functools.lru_cache(maxsize=1)
def first_k2():
    """chip_smoke.FirstK2: the first K2 (bench_sources/probe_recon_first.cu)
    built and called as its wrapper called it."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.FirstK2()


# test_k2_matches_plain's shapes, and a 12 MP photo at two qualities.
@pytest.mark.parametrize("sub", [True, False], ids=["420", "444"])
@pytest.mark.parametrize("w,h,bsz,quality", [
    (1, 1, 2, None), (9, 17, 3, None), (17, 9, 1, None), (500, 500, 4, None),
    (499, 499, 3, None), (1000, 9, 1, None), (600, 3, 2, None),
    (700, 513, 2, None), (513, 700, 1, None), (1920, 1080, 1, None),
    (4032, 3024, 1, 30), (4032, 3024, 1, 90)])
def test_k2_equals_the_first_k2(cuda_device, w, h, bsz, sub, quality):
    """The redesigned K2 gives the first K2's luminance bit for bit: the
    same roundings in the same order, zero terms skipped exactly, integer
    box sums."""
    from fennec_tpu_torch.engine import compress as C

    inp = k2_inputs(w, h, sub, bsz, cuda_device, seed=w + h)
    q = (torch.from_numpy(np.random.default_rng(w * h).integers(1, 101, bsz))
         if quality is None else torch.full((bsz,), quality)).to(cuda_device)
    assert torch.equal(C.probe_luminance(inp, q), first_k2()(inp, q))


def test_k2_on_a_side_stream(cuda_device):
    from fennec_tpu_torch.engine import compress as C

    inp = k2_inputs(700, 513, True, 3, cuda_device, seed=9)
    q = torch.tensor([20, 55, 90], device=cuda_device)
    want = C.probe_luminance(inp, q)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = C.probe_luminance(inp, q)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_k2_rejects_bad_inputs_on_card(cuda_device):
    import dataclasses

    from fennec_tpu_torch.engine import compress as C

    inp = k2_inputs(96, 80, True, 2, cuda_device)
    q = torch.tensor([40, 60], device=cuda_device)
    with pytest.raises(TypeError):
        C.probe_luminance(dataclasses.replace(
            inp, cplanes=tuple(p.half() for p in inp.cplanes)), q)
    with pytest.raises(ValueError):
        C.probe_luminance(inp, q[:1])
    with pytest.raises(ValueError):
        C.probe_luminance(dataclasses.replace(inp, dmat=inp.dmat.cpu()), q)
    # A search's inputs are checked once; each probe checks its quality.
    C.probe_luminance(inp, q)
    assert inp.k2_state is not None
    with pytest.raises(ValueError):
        C.probe_luminance(inp, q.cpu())
    with pytest.raises(ValueError):
        C.probe_luminance(inp, torch.cat([q, q]))


def test_standard_mode_never_takes_the_plain_probe(cuda_device, monkeypatch):
    """compress_image on the card scores every probe through K2 (seven
    launches) and K1 and never calls probe_luminance_plain, with and
    without the SSIMFast downsample; the quality is the CPU's."""
    from fennec_tpu_torch.engine import compress as C
    from fennec_tpu_torch.ops.probe_recon_cuda import probe_recon

    imgs = [photo(320, 240, 3), photo(700, 520, 4)]
    on_cpu = [T.compress_image(None, img, T.Options(), device="cpu")
              for img in imgs]

    def refuse(*args, **kw):
        raise AssertionError("a CUDA probe reached the plain version")

    monkeypatch.setattr(C, "probe_luminance_plain", refuse)
    monkeypatch.setattr(C, "_reconstruct_rgb_planes", refuse)
    for img, want in zip(imgs, on_cpu):
        before = (probe_recon.launches, ssim_window.launches)
        got = T.compress_image(None, img, T.Options(), device=cuda_device)
        assert probe_recon.launches == before[0] + 7
        assert ssim_window.launches == before[1] + 7
        assert got.jpeg_quality == want.jpeg_quality
        assert abs(got.ssim - want.ssim) <= ATOL


# ── The mesh over one card (two shards on cuda:0) ───────────────────────────


def test_batch_engines_on_a_one_card_mesh(cuda_device):
    """compress_images and the coefficient path over ["cuda:0", "cuda:0"]:
    the bytes of one device, K1, K2, K3a and K3b launched once per
    non-empty shard for each launch a one-device chunk makes."""
    from fennec_tpu_torch.engine import batched as B
    from fennec_tpu_torch.ops import jpeg_emit_cuda as k3
    from fennec_tpu_torch.ops.probe_recon_cuda import probe_recon

    kernels = (ssim_window, probe_recon, k3.block_stats, k3.deposit)
    imgs = [photo(96, 80, s) for s in range(5)]
    datas = [T.encode_to_bytes(img, T.JPEG, 92, device=cuda_device)
             for img in imgs]
    opts = T.Options(format=T.JPEG)
    for run in (lambda dev: T.compress_images(None, imgs, opts, device=dev),
                lambda dev: B.compress_jpeg_bytes_batched(None, datas, opts,
                                                          device=dev)):
        counts = []
        outs = []
        for dev in ("cuda:0", ["cuda:0", "cuda:0"]):
            before = [k.launches for k in kernels]
            outs.append(run(dev))
            counts.append([k.launches - b for k, b in zip(kernels, before)])
        assert [r.compressed_data for r in outs[0]] == \
            [r.compressed_data for r in outs[1]]
        # One chunk of 5: one shard alone, then two shards (3 + 2).
        assert counts[1] == [2 * c for c in counts[0]]
        assert counts[0] == [7, 7, 1, 1]


def test_sharded_functions_on_a_one_card_mesh(cuda_device):
    from fennec_tpu_torch.parallel import batched as pb

    mesh = pb.data_mesh(["cuda:0", "cuda:0", "cuda:0"])
    rng = np.random.default_rng(5)
    imgs = torch.from_numpy(rng.integers(0, 256, (5, 64, 48, 4),
                                         dtype=np.uint8)).to(cuda_device)
    imgs[..., 3] = 255
    targets = [0.9, 0.94, 0.97, 0.85, 0.99]
    q1, s1, f1 = pb.batched_quality_search(imgs, targets)
    q2, s2, f2 = pb.batched_quality_search_sharded(mesh, imgs, targets)
    assert torch.equal(q1, q2) and torch.equal(f1, f2)
    assert torch.equal(s1, s2)
    e1 = pb.batched_search_emit(imgs, targets)
    e2 = pb.batched_search_emit_sharded(mesh, imgs, targets)
    np.testing.assert_array_equal(e1[0], e2[0])
    assert e1[1].tobytes() == e2[1].tobytes()
    assert [e1[3].scan(j) for j in range(5)] == \
        [e2[3].scan(j) for j in range(5)]
    z1 = pb.batched_size_search(imgs, 900, 1, 100)
    z2 = pb.batched_size_search_sharded(mesh, imgs, 900, 1, 100)
    assert all(torch.equal(a, b) for a, b in zip(z1, z2))
    b = torch.clamp(imgs.float() + 9, 0, 255)
    assert torch.equal(pb.batched_ssim(imgs, b),
                       pb.batched_ssim_sharded(mesh, imgs, b))


def test_shard_threads_build_once_and_count_every_launch(cuda_device,
                                                         tmp_path,
                                                         monkeypatch):
    """Two shard threads launch a fresh K1 at once: nvcc runs once and
    every launch is counted."""
    from fennec_tpu_torch.ops import ssim_cuda
    from fennec_tpu_torch.parallel import batched as pb

    builds = []
    real = ssim_cuda.compile_library

    def counted(*args):
        builds.append(args[1])
        return real(*args)

    monkeypatch.setattr(ssim_cuda, "compile_library", counted)
    fresh = ssim_cuda.WindowedSsimKernel(
        library=str(tmp_path / "libssim_window.so"))
    a, b = noise_pair((8, 96, 128), 3, cuda_device)

    def fn(x, y):
        return [fresh(x.contiguous(), y.contiguous()) for _ in range(10)][-1]

    got = pb.shard_data_call(pb.data_mesh(["cuda:0", "cuda:0"]), fn, a, b)
    assert len(builds) == 1 and fresh.launches == 20
    assert torch.equal(got, ssim_window(a, b))


# ── The data×spatial mesh: K2 on bands of one card ──────────────────────────


def spatial_photo(h, w, seed):
    """Gradients and blocky noise on integer levels, opaque."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.empty((h, w, 4), np.float32)
    img[..., 0], img[..., 1] = x * 255.0 / w, y * 255.0 / h
    img[..., 2] = (x + y) * 255.0 / (w + h)
    noise = rng.normal(0, 12, (h // 8 + 1, w // 8 + 1, 3))
    img[..., :3] += noise.repeat(8, 0).repeat(8, 1)[:h, :w]
    img[..., :3] = np.floor(np.clip(img[..., :3], 0, 255))
    img[..., 3] = 255.0
    return img


# (H, W, bands): rectangles straddling the seams (1280 x 576, 4000 x
# 3008), seams on rectangle edges (the 12 MP portrait), bands that own no
# output row (9728 x 160).
@pytest.mark.parametrize("h,w,n", [(576, 1280, 4), (3008, 4000, 4),
                                   (4032, 3024, 2), (160, 9728, 10)])
def test_band_k2_bit_equal_to_the_whole_image(cuda_device, monkeypatch, h,
                                              w, n):
    """quality_search_spatial_sharded on n bands of one card: every
    band's K2 luminance at each probe is bit-equal to the rows it owns
    of K2 on the whole image, and the result equals the unsharded
    search's ((q, found), blocks; SSIM within 1e-5)."""
    from fennec_tpu_torch.engine import compress as tcomp
    from fennec_tpu_torch.ops.probe_recon_cuda import probe_recon
    from fennec_tpu_torch.parallel import batched as pb
    from fennec_tpu_torch.parallel import mesh as pm

    img = torch.from_numpy(spatial_photo(h, w, h + n)).to(cuda_device)
    calls = []
    inner = tcomp.probe_luminance

    def probe(inp, quality):
        lum = inner(inp, quality)
        calls.append((inp.band, quality.clone(), lum.clone()))
        return lum

    monkeypatch.setattr(pb._compress, "probe_luminance", probe)
    mesh = pm.data_spatial_mesh(n, n, [cuda_device] * n)
    before = probe_recon.launches
    q, s, f, blocks = pb.quality_search_spatial_sharded(mesh, img, 0.94)
    torch.cuda.synchronize()
    monkeypatch.undo()
    owners = len({band for band, _, _ in calls})
    assert probe_recon.launches - before == 7 * owners == len(calls)
    inp, _ = tcomp.prepare_search(img[None], True)
    for band, quality, lum in calls:
        whole = probe_recon(inp, quality)
        assert torch.equal(lum[0], whole[0, band.d0:band.d1]), band
    uq, us, uf, ublocks = tcomp.batched_quality_search_quantize(
        img[None], [0.94], True)
    assert (int(q), bool(f)) == (int(uq[0]), bool(uf[0]))
    assert abs(float(s) - float(us[0])) <= ATOL
    got = torch.cat(blocks).to(torch.int16).cpu().numpy()
    np.testing.assert_array_equal(got, ublocks[0])


def test_spatial_ssim_matches_batched_ssim(cuda_device):
    from fennec_tpu_torch.parallel import batched as pb
    from fennec_tpu_torch.parallel import mesh as pm

    a, b = noise_pair((3, 200, 300), 5, cuda_device)
    a4, b4 = (torch.stack([x] * 4, dim=-1) for x in (a, b))
    mesh = pm.data_spatial_mesh(8, 4, [cuda_device] * 8)
    got = pb.batched_ssim_sharded(mesh, a4, b4, spatial=True)
    torch.testing.assert_close(got, pb.batched_ssim(a4, b4), atol=ATOL,
                               rtol=0)
