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
def chip_smoke():
    """The chip_smoke.py module of this checkout."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=1)
def first_k2():
    """chip_smoke.FirstK2: the first K2 (bench_sources/probe_recon_first.cu)
    built and called as its wrapper called it."""
    return chip_smoke().FirstK2()


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


def test_k5_matches_plain_and_host_builder(cuda_device):
    """K5 on every family of chip_smoke.k5_families: tables and header bit
    for bit its plain version's on the same tensors, and the host C++
    builder's (errors for exactly the flagged images); one launch per
    call."""
    from fennec_tpu_torch.ops.huffbuild_cuda import build_tables

    for tag, hist in chip_smoke().k5_families():
        before = build_tables.launches
        chip_smoke().check_k5(tag, torch.from_numpy(hist).to(cuda_device))
        assert build_tables.launches == before + 2


def test_k5_never_takes_the_plain_version(cuda_device, monkeypatch):
    """CUDA tensors launch K5 or raise: an optimal emission on the card
    builds its tables with one K5 launch, never the plain version."""
    from fennec_tpu_torch.ops import huffbuild_cuda as k5

    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(k5, "build_plain", refuse)
    before = (k5.build_tables.launches, k5.build_tables.plain_calls)
    img = photo(120, 90, 3)
    on_card = T.compress_image(None, img, T.Options(format=T.JPEG),
                               device=cuda_device)
    assert (k5.build_tables.launches, k5.build_tables.plain_calls) == (
        before[0] + 1, before[1])
    host = T.compress_image(None, img, T.Options(format=T.JPEG,
                                                 device_entropy=False),
                            device=cuda_device)
    assert on_card.compressed_data == host.compressed_data


@pytest.mark.parametrize("sub", [True, False], ids=["420", "444"])
@pytest.mark.parametrize("w,h,bsz", [(500, 500, 8), (17, 9, 3), (1920, 1080,
                                                                 1)])
def test_k5_emission_equals_host_built_flow(cuda_device, w, h, bsz, sub):
    """emit_scans (K3a, K5, K3b) writes the bytes of the host-built flow
    (K3a, the C++ K.2 build, emit_custom) and the same DHT specs."""
    from fennec_tpu_torch.parallel.batched import emit_scans

    packed = k3_blocks(h, w, sub, bsz, w + h)[0].to(cuda_device)
    got = emit_scans(packed, h, w, sub, True)
    want = chip_smoke().host_built_emit(packed, h, w, sub)
    assert got.specs == want.specs and not got.errors
    for j in range(bsz):
        assert got.jpeg(j, w, h, 50, sub) == want.jpeg(j, w, h, 50, sub)


@pytest.mark.parametrize("fam", ["batch64_mixed", "ac_162_live"])
def test_k5_on_a_side_stream(cuda_device, fam):
    """K5 launches on the current stream: built on a side stream, the
    tables equal the default stream's."""
    from fennec_tpu_torch.ops.huffbuild_cuda import build_tables
    from fennec_tpu_torch.ops.jpeg_emit import std_tables_on

    hist = torch.from_numpy(dict(chip_smoke().k5_families())[fam]).to(
        cuda_device)
    std = std_tables_on(cuda_device)
    want = build_tables(hist, std)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        got = build_tables(hist, std)
    torch.cuda.synchronize()
    assert torch.equal(got.tables, want.tables)
    assert torch.equal(got.header, want.header)


# ── K6 and the upload routes ────────────────────────────────────────────────


def k6_files(kind, device):
    """Files of one geometry for K6's cases: photo content, noise at Q100
    (values past int8, more AC nonzeros than slots), 4:4:4, ragged."""
    rng = np.random.default_rng(17)
    if kind == "photo":
        imgs, q, sub = [photo(500, 500, s) for s in range(4)], 92, True
    elif kind == "noise_q100":
        imgs = [rng.integers(0, 256, (96, 128, 4), dtype=np.uint8)
                for _ in range(3)]
        q, sub = 100, True
    elif kind == "444":
        imgs, q, sub = [photo(136, 72, s) for s in range(3)], 95, False
    else:
        w, h = (17, 9) if kind == "17x9" else (513, 700)
        imgs, q, sub = [photo(w, h, s) for s in range(3)], 95, True
    for img in imgs:
        img[..., 3] = 255
    from fennec_tpu_torch.codecs.jpeg import encode_jpeg

    return [encode_jpeg(img, q, sub, device=device) for img in imgs]


@functools.lru_cache(maxsize=1)
def first_k6():
    """chip_smoke.FirstK6: the first K6 (bench_sources/coef_wire_first.cu)
    built and called through the port's wrappers."""
    return chip_smoke().FirstK6()


@pytest.mark.parametrize("kind", ["photo", "noise_q100", "444", "17x9",
                                  "513x700"])
def test_k6_matches_plain_and_decoder(cuda_device, kind):
    """K6 on every layout equals its plain version on the same CUDA
    tensors, the C++ decoder's blocks and the first K6, bit for bit
    (chip_smoke.check_k6); two launches per layout (the check calls it
    twice), the first K6's counted apart."""
    cs = chip_smoke()
    before = {k: w.launches for k, w in cs.k6_wrappers().items()}
    cs.check_k6(kind, k6_files(kind, "cpu"), cuda_device, first=first_k6())
    assert {k: w.launches - before[k]
            for k, w in cs.k6_wrappers().items()} == {"coo": 2, "i8": 2,
                                                      "csr": 2}


@pytest.mark.parametrize("layout", ["coo", "i8", "csr"])
def test_k6_cases_match_plain_and_the_first_k6(cuda_device, layout):
    """K6 on chip_smoke.k6_cases, bit for bit against its plain version
    and the first K6: every R of COO_RS and K in {1, 8, 63, 64}, B x NT
    and a CSR image's NT no multiple of the tile, a CSR image with no
    pairs, E = 0, exception rows at a block's DC and its last
    coefficient, dead rows, offsets outside the image, rows in no order,
    and rows 1.. of a chunk, whose sections start at addresses that are
    no multiple of 16."""
    cs = chip_smoke()
    cases = [c for c in cs.k6_cases() if c[1] == layout]
    assert cases
    for tag, _, secs in cases:
        secs = [x.to(cuda_device) for x in secs]
        if tag.endswith("_rows1"):
            secs = [x[1:] for x in secs]
            assert any(x.data_ptr() % 16 for x in secs[:-3]), tag
        cs.k6_agree(tag, layout, secs, first_k6())
    torch.cuda.synchronize()


def test_k6_csr_scratch_is_the_libraries_own(cuda_device):
    """The CSR wrapper's scratch is what K6's library asks per image:
    each tile's first pair (tiles of TILE blocks) and the image's
    pairs."""
    from fennec_tpu_torch.ops import coef_wire_cuda as k6

    lib = k6.library.load()
    for nt in (1, 63, 64, 65, 6144, 285_768):
        assert lib.fennec_wire_csr_tiles(nt) == -(-nt // k6.TILE) + 1


@pytest.mark.parametrize("env,event", [({}, "upload_coo"),
                                       ({"FENNEC_UPLOAD": "dense"},
                                        "upload_i8"),
                                       ({"FENNEC_UPLOAD": "csr"},
                                        "upload_csr")])
def test_routes_on_card_never_take_the_plain_version(cuda_device, monkeypatch,
                                                     env, event):
    """An unresized chunk on the card goes up compact and K6 rebuilds it,
    one launch per chunk, never the plain version; the bytes are the
    CPU's (its plain version)."""
    from fennec_tpu_torch.engine.batched import (
        compress_jpeg_bytes_batched,
        counters,
    )
    from fennec_tpu_torch.ops import coef_wire_cuda as k6

    def refuse(*args, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    datas = k6_files("photo", "cpu")
    opts = T.Options(format=T.JPEG)
    on_cpu = compress_jpeg_bytes_batched(None, datas, opts, device="cpu")
    for w in (k6.unpack_coo, k6.unpack_i8, k6.unpack_csr):
        monkeypatch.setattr(w, "_plain", refuse)
    wrapper = {"upload_coo": k6.unpack_coo, "upload_i8": k6.unpack_i8,
               "upload_csr": k6.unpack_csr}[event]
    before = wrapper.launches
    counters.reset()
    on_card = compress_jpeg_bytes_batched(None, datas, opts,
                                          device=cuda_device)
    assert counters.snapshot()["events"] == {event: 1}
    assert wrapper.launches == before + 1
    for a, b in zip(on_card, on_cpu):
        assert a.jpeg_quality == b.jpeg_quality
        assert abs(a.ssim - b.ssim) <= ATOL


def test_k6_failure_raises_with_no_fallback(cuda_device, monkeypatch):
    """A K6 library that does not build raises out of the engine: no path
    back to int16 blocks or to the plain version."""
    from fennec_tpu_torch.engine.batched import compress_jpeg_bytes_batched
    from fennec_tpu_torch.ops import coef_wire_cuda as k6

    def broken():
        raise RuntimeError("fennec: nvcc failed (test)")

    monkeypatch.setattr(k6.library, "load", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        compress_jpeg_bytes_batched(None, k6_files("photo", "cpu"),
                                    T.Options(format=T.JPEG),
                                    device=cuda_device)


def test_k6_on_a_side_stream(cuda_device):
    """K6 launches on the current stream: rebuilt on a side stream, the
    blocks equal the default stream's."""
    cs = chip_smoke()
    sections, *_ = cs.wire_sections(k6_files("noise_q100", "cpu"),
                                    cuda_device)
    for layout, secs in sections.items():
        want = cs.k6_wrappers()[layout](*secs)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            got = cs.k6_wrappers()[layout](*secs)
        torch.cuda.synchronize()
        assert torch.equal(got, want), layout


def test_yuv420_wire_on_card_matches_cpu(cuda_device, monkeypatch):
    """FENNEC_PIXEL_WIRE=yuv420 on the card: the chunk goes up as the
    wire, with the CPU's qualities and SSIM within 1e-5."""
    from fennec_tpu_torch.engine.batched import counters

    monkeypatch.setenv("FENNEC_PIXEL_WIRE", "yuv420")
    imgs = [photo(160, 120, s) for s in range(4)]
    opts = T.Options(format=T.JPEG, device_entropy=True)
    counters.reset()
    on_card = T.compress_images(None, imgs, opts, device=cuda_device)
    assert counters.snapshot()["events"] == {"upload_yuv420": 1}
    on_cpu = T.compress_images(None, imgs, opts, device="cpu")
    for a, b in zip(on_card, on_cpu):
        assert a.jpeg_quality == b.jpeg_quality
        assert abs(a.ssim - b.ssim) <= ATOL


def test_routes_without_exceptions_on_card(cuda_device, monkeypatch):
    """Flat content at a low quality has no value past int8: each route's
    exception tensors are (B, 0), pinned and uploaded empty, and the bytes
    are the CPU's."""
    from fennec_tpu_torch.codecs.jpeg import encode_jpeg
    from fennec_tpu_torch.engine.batched import (
        compress_jpeg_bytes_batched,
        counters,
    )

    imgs = [np.full((64, 80, 4), v, np.uint8) for v in (120, 128, 136)]
    datas = [encode_jpeg(img, 50, True, device="cpu") for img in imgs]
    opts = T.Options(format=T.JPEG)
    for env in ({}, {"FENNEC_UPLOAD": "dense"}, {"FENNEC_UPLOAD": "csr"}):
        monkeypatch.delenv("FENNEC_UPLOAD", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        counters.reset()
        on_card = compress_jpeg_bytes_batched(None, datas, opts,
                                              device=cuda_device)
        assert len(counters.snapshot()["events"]) == 1
        on_cpu = compress_jpeg_bytes_batched(None, datas, opts,
                                             device="cpu")
        assert [r.compressed_data for r in on_card] == \
            [r.compressed_data for r in on_cpu]


# ── K7 (the decode's device stage) and K8 (the forward DCT, the original's
# luminance) ────────────────────────────────────────────────────────────────

K7_FRAMES = [("gray", [(1, 1)], "gray"),
             ("ycbcr_420", [(2, 2), (1, 1), (1, 1)], "ycbcr"),
             ("ycbcr_422", [(2, 1), (1, 1), (1, 1)], "ycbcr"),
             ("ycbcr_444", [(1, 1)] * 3, "ycbcr"),
             ("adobe_rgb", [(1, 1)] * 3, "rgb"),
             ("cmyk", [(1, 1)] * 4, "cmyk"),
             ("ycck_420", [(2, 2), (1, 1), (1, 1), (2, 2)], "ycck")]


@pytest.mark.parametrize("tag,sampling,mode", K7_FRAMES)
@pytest.mark.parametrize("wh", [(1001, 753), (17, 9), (353, 40)])
def test_k7_matches_plain(cuda_device, tag, sampling, mode, wh):
    """K7 on every mode and sampling against reconstruct_plain on the same
    CUDA tensors: every differing pixel at a rounding tie; two calls
    bit-identical; one launch a call, never the plain version."""
    from fennec_tpu_torch.codecs.jpeg import reconstruct_plain
    from fennec_tpu_torch.ops.decode_recon_cuda import decode_recon

    cs = chip_smoke()
    args = cs.k7_synthetic(sampling, mode, *wh, sum(wh) + len(tag),
                           cuda_device)
    before, plain = decode_recon.launches, decode_recon.plain_calls
    got = decode_recon.frame(*args)
    again = decode_recon.frame(*args)
    torch.cuda.synchronize()
    assert decode_recon.launches == before + 2
    assert decode_recon.plain_calls == plain
    assert got.dtype == torch.uint8 and got.shape == (wh[1], wh[0], 4)
    assert torch.equal(got, again)
    cs.k7_compare(tag, got, reconstruct_plain(*args),
                  cs.k7_round_inputs(*args))


def test_k7_dc_tie_decodes_to_129(cuda_device):
    """A flat block of quantized DC 1 at q = 4 is exactly 128.5: K7 sums
    with the float32 Kron matrix, whose row 0 is 0.125, and gives 129."""
    from fennec_tpu_torch.ops.decode_recon_cuda import decode_recon

    blocks = torch.zeros((1, 64), dtype=torch.int16, device=cuda_device)
    blocks[0, 0] = 1
    tables = torch.full((1, 64), 4, dtype=torch.int32, device=cuda_device)
    got = decode_recon.frame([blocks], tables, [(1, 1, 1, 1)], 1, 1, 8, 8,
                             "gray")
    assert (got[..., :3] == 129).all() and (got[..., 3] == 255).all()


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("tag,sampling,mode,wh", [
    ("ycbcr_420_12mp", [(2, 2), (1, 1), (1, 1)], "ycbcr", (4032, 3024)),
    ("ycbcr_444_1080p", [(1, 1)] * 3, "ycbcr", (1920, 1080))] + [
    (tag, sampling, mode, wh) for tag, sampling, mode in K7_FRAMES
    for wh in ((353, 40), (17, 9))])
def test_k7_oriented_is_apply_orientation_of_identity(
        cuda_device, orientation, tag, sampling, mode, wh):
    """K7 at an EXIF orientation stores each pixel upright: its image is
    orient_plain (exif.apply_orientation) of its image at orientation 1,
    bit for bit, and the plain route's at the same orientation but at
    rounding ties."""
    from fennec_tpu_torch.codecs.jpeg import reconstruct_plain
    from fennec_tpu_torch.ops.decode_recon_cuda import (
        decode_recon,
        orient_plain,
    )

    cs = chip_smoke()
    args = cs.k7_synthetic(sampling, mode, *wh, sum(wh) + len(tag),
                           cuda_device)
    upright = decode_recon.frame(*args)
    before = (decode_recon.launches, decode_recon.oriented,
              decode_recon.plain_calls)
    got = decode_recon.frame(*args, orientation)
    assert (decode_recon.launches, decode_recon.oriented,
            decode_recon.plain_calls) == (
        before[0] + 1, before[1] + (orientation != 1), before[2])
    want = orient_plain(upright, orientation)
    assert got.shape == want.shape and torch.equal(got, want)
    if max(wh) < 2000:
        cs.k7_compare(tag, got, reconstruct_plain(*args, orientation),
                      orient_plain(cs.k7_round_inputs(*args), orientation))


def exif_rotated(data: bytes, orientation: int) -> bytes:
    """A JPEG with an APP1 EXIF segment holding only an orientation tag."""
    import struct

    tiff = (struct.pack(">2sHIH", b"MM", 42, 8, 1)
            + struct.pack(">HHIHHI", 0x0112, 3, 1, orientation, 0, 0))
    payload = b"Exif\x00\x00" + tiff
    return (data[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2)
            + payload + data[2:])


def test_compress_file_decodes_rotated_files_upright(cuda_device, tmp_path):
    """compress_file of a rotated JPEG on the card: K7 stores it upright
    (decode_recon.oriented counts each such call, and only those), the
    result the CPU's, the image exif.apply_orientation of the stored
    pixels."""
    from fennec_tpu_torch.exif import apply_orientation
    from fennec_tpu_torch.ops.decode_recon_cuda import decode_recon

    data = T.encode_to_bytes(photo(700, 540, 4), T.JPEG, 92, device="cpu")
    stored = T.codecs.decode_image(data, device=cuda_device)
    for o in (1, 6, 3, 8, 5):
        src = tmp_path / f"in{o}.jpg"
        src.write_bytes(exif_rotated(data, o))
        before = decode_recon.oriented
        on_card = T.compress_file(None, str(src), str(tmp_path / "o.jpg"),
                                  device=cuda_device)
        assert decode_recon.oriented == before + (o != 1)
        assert np.array_equal(on_card.image, apply_orientation(stored, o))
        on_cpu = T.compress_file(None, str(src), str(tmp_path / "c.jpg"),
                                 device="cpu")
        assert on_card.jpeg_quality == on_cpu.jpeg_quality
        assert on_card.original_dimensions == on_cpu.original_dimensions
    before = decode_recon.oriented
    T.compress_bytes(None, exif_rotated(data, 6), device=cuda_device)
    assert decode_recon.oriented == before


@pytest.mark.parametrize("sub", [True, False])
def test_k7_batch_matches_plain_and_decode_jpeg(cuda_device, sub):
    """decode_jpeg_image on the card (K7's batch entry) against its plain
    version, each image alone against the batch, and each against
    codecs/jpeg.decode_jpeg of its file (K7's frame entry)."""
    from fennec_tpu_torch.codecs.jpeg import (
        decode_jpeg,
        decode_jpeg_to_coefs,
        encode_jpeg,
        parse_jpeg,
    )
    from fennec_tpu_torch.engine.compress import (
        decode_jpeg_image,
        decode_jpeg_image_plain,
    )

    datas = [encode_jpeg(photo(77, 45, s), 90, sub, device="cpu")
             for s in range(5)]
    blocks = torch.stack([torch.from_numpy(np.concatenate(
        decode_jpeg_to_coefs(d)[1])) for d in datas]).to(cuda_device)
    hdr = parse_jpeg(datas[0])
    qt = torch.from_numpy(np.stack([hdr.qtables[0], hdr.qtables[1]]))
    qt = qt[None].expand(5, 2, 64).contiguous().to(cuda_device)
    got = decode_jpeg_image(blocks, qt, 45, 77, sub)
    want = decode_jpeg_image_plain(blocks, qt, 45, 77, sub)
    assert got.dtype == torch.float32 and got.shape == (5, 45, 77, 4)
    assert int((got - want).abs().max()) <= 1
    for i in range(5):
        alone = decode_jpeg_image(blocks[i:i + 1], qt[i:i + 1], 45, 77, sub)
        assert torch.equal(alone[0], got[i])
        frame = decode_jpeg(datas[i], device=cuda_device)
        assert np.array_equal(frame, got[i].to(torch.uint8).cpu().numpy())


@pytest.mark.parametrize("sub", [True, False])
@pytest.mark.parametrize("shape", [(64, 500, 500), (2, 37, 93), (1, 9, 17)])
def test_k8_dct_matches_plain_and_batch(cuda_device, sub, shape):
    """K8's DCT against forward_dct_plain on the same CUDA images
    (levels at Q30/60/92 equal except at ties), and every image alone
    bit-equal to its blocks inside the batch."""
    from fennec_tpu_torch.codecs.jpeg import forward_dct, forward_dct_plain
    from fennec_tpu_torch.ops import forward_dct_cuda as k8

    cs = chip_smoke()
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, (*shape, 4)).astype(np.float32)
    x = torch.from_numpy(img).to(cuda_device)
    before, plain = k8.forward_dct.launches, k8.forward_dct.plain_calls
    got = forward_dct(x, sub)
    assert k8.forward_dct.launches == before + 1
    assert k8.forward_dct.plain_calls == plain
    want = forward_dct_plain(x, sub)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) < 2e-3
    cs.k8_levels(f"{shape}", got, want, (30, 60, 92), cuda_device)
    for i in range(shape[0]):
        alone = forward_dct(x[i], sub)
        for a, b in zip(alone, got):
            assert torch.equal(a, b[i])


@pytest.mark.parametrize("wh", [(4032, 3024), (700, 20), (500, 500),
                                (9, 613)])
def test_k8_luminance_is_the_exact_box_mean(cuda_device, wh):
    """The original's luminance on the card: the exact box means' (K2's
    rounding) bit for bit, the plain version's except at box-mean ties;
    without a downsample the plain version's exactly."""
    from fennec_tpu_torch.engine import compress as C

    cs = chip_smoke()
    w, h = wh
    x = torch.from_numpy(photo(w, h, 3)).to(cuda_device).float()[None]
    wh_, wv, rect = C._ssim_box(w, h, cuda_device)
    got = C.original_luminance(x, wh_, wv, rect, h)
    want = C.lum_orig_plain(x, wh_, wv, h)
    assert got.shape == want.shape
    cs.k8_lum_compare(f"{wh}", got, want, x, rect, got.shape[1],
                      got.shape[2])


def test_k8_luminance_on_bands_is_the_whole_images(cuda_device):
    """Each band's K8 luminance (band_inputs) equals its rows of the whole
    image's, bit for bit: the sums are integers."""
    from fennec_tpu_torch.engine import compress as C
    from fennec_tpu_torch.ops import resize as R
    from fennec_tpu_torch.ops.ssim import ssim_fast_dims

    w, h = 4000, 3008
    x = torch.from_numpy(photo(w, h, 5)).to(cuda_device).float()[None]
    whole = C.original_luminance(x, *C._ssim_box(w, h, cuda_device), h)
    ds_w, ds_h = ssim_fast_dims(w, h)
    for k in range(4):
        band = R.box_band(h, ds_h, k * h // 4, (k + 1) * h // 4, 16)
        wh_, wv, rect = R.band_box_device(w, ds_w, band, cuda_device)
        got = C.original_luminance(x[:, band.start:band.end], wh_, wv, rect,
                                   band.stop - band.start)
        assert torch.equal(got[0], whole[0, band.d0:band.d1])


@functools.lru_cache(maxsize=1)
def first_k7():
    """chip_smoke.FirstK7: the first K7 (bench_sources/decode_recon_first.cu)
    built and called through the port's wrapper class."""
    return chip_smoke().FirstK7()


@functools.lru_cache(maxsize=1)
def first_k8():
    """chip_smoke.FirstK8: the first K8 (bench_sources/forward_dct_first.cu)
    built and its DCT called through the port's entry class."""
    return chip_smoke().FirstK8()


@pytest.mark.parametrize("tag,sampling,mode", K7_FRAMES)
@pytest.mark.parametrize("wh", [(1001, 753), (17, 9), (353, 40), (8, 8),
                                (2100, 16)])
def test_k7_equals_the_first_k7(cuda_device, tag, sampling, mode, wh):
    """The redesigned K7 gives the first K7's pixels bit for bit on every
    mode and sampling (the same fmaf chains over k ascending, zero terms
    skipped exactly), and on the batch entry of a 4:2:0 and a 4:4:4
    chunk."""
    from fennec_tpu_torch.ops.decode_recon_cuda import decode_recon

    cs = chip_smoke()
    args = cs.k7_synthetic(sampling, mode, *wh, sum(wh) * 3 + len(tag),
                           cuda_device)
    assert torch.equal(decode_recon.frame(*args), first_k7().k7.frame(*args))
    if tag == "gray" and wh == (1001, 753):
        for sub in (True, False):
            s = 2 if sub else 1
            w, h = 77, 45
            mx, my = -(-w // (8 * s)), -(-h // (8 * s))
            nt = mx * my * (s * s + 2)
            rng = np.random.default_rng(nt)
            blocks = torch.from_numpy(np.where(
                rng.random((5, nt, 64)) < 0.2,
                rng.integers(-60, 60, (5, nt, 64)), 0).astype(np.int16))
            qt = torch.from_numpy(rng.integers(1, 30, (5, 2, 64)).astype(
                np.int32))
            blocks, qt = blocks.to(cuda_device), qt.to(cuda_device)
            assert torch.equal(decode_recon.batch(blocks, qt, h, w, sub),
                               first_k7().k7.batch(blocks, qt, h, w, sub))


@pytest.mark.parametrize("sub", [True, False])
@pytest.mark.parametrize("shape", [(64, 500, 500), (2, 37, 93), (1, 9, 17),
                                   (1, 3024, 4032), (3, 16, 2000)])
def test_k8_dct_equals_the_first_k8(cuda_device, sub, shape):
    """The redesigned K8 DCT gives the first K8's coefficients bit for bit
    (each a chain of fmaf over the pixels ascending), on whole images and
    on a band of rows (a view)."""
    from fennec_tpu_torch.codecs.jpeg import forward_dct

    rng = np.random.default_rng(sum(shape) + sub)
    img = rng.integers(0, 256, (*shape, 4)).astype(np.float32)
    x = torch.from_numpy(img).to(cuda_device)
    for view in (x, x[:, shape[1] // 3:]):
        for a, b in zip(forward_dct(view, sub), first_k8().fdct(view, sub)):
            assert torch.equal(a, b)


def test_k7_k8_failure_raises_with_no_fallback(cuda_device, monkeypatch):
    """A K7 or K8 library that does not build raises out of the entry
    points on the card: no plain result comes back."""
    from fennec_tpu_torch.ops import forward_dct_cuda as k8
    from fennec_tpu_torch.ops.decode_recon_cuda import decode_recon

    def broken():
        raise RuntimeError("fennec: nvcc failed (test)")

    data = T.encode_to_bytes(photo(96, 64, 1), T.JPEG, 90, device="cpu")
    for target in (decode_recon, k8.library):
        with monkeypatch.context() as m:
            m.setattr(target, "load", broken)
            plain = (decode_recon.plain_calls, k8.forward_dct.plain_calls,
                     k8.original_luminance.plain_calls)
            with pytest.raises(RuntimeError, match="nvcc failed"):
                T.compress_bytes(None, data, T.Options(), device=cuda_device)
            assert plain == (decode_recon.plain_calls,
                             k8.forward_dct.plain_calls,
                             k8.original_luminance.plain_calls)


def test_main_path_runs_through_k7_and_k8(cuda_device):
    """compress_bytes on the card decodes with K7 and searches from K8's
    blocks and luminance: each launched, no plain version taken; the
    result is the CPU's quality."""
    from fennec_tpu_torch.ops import forward_dct_cuda as k8
    from fennec_tpu_torch.ops.decode_recon_cuda import decode_recon

    data = T.encode_to_bytes(photo(700, 540, 2), T.JPEG, 92, device="cpu")
    ws = (decode_recon, k8.forward_dct, k8.original_luminance)
    before = [(w.launches, w.plain_calls) for w in ws]
    on_card = T.compress_bytes(None, data, T.Options(), device=cuda_device)
    after = [(w.launches, w.plain_calls) for w in ws]
    for (l0, p0), (l1, p1) in zip(before, after):
        assert l1 > l0 and p1 == p0
    on_cpu = T.compress_bytes(None, data, T.Options(), device="cpu")
    assert on_card.jpeg_quality == on_cpu.jpeg_quality
    assert abs(on_card.ssim - on_cpu.ssim) <= ATOL


def test_stages_are_host_ranges_only_in_a_card_trace(cuda_device):
    """Under torch.profiler on the card, each stage of compress_bytes is
    a host range and never a device event: the device's events are the
    kernels, copies and sets alone, as the benchmark's trace reader
    counts them."""
    from torch.profiler import ProfilerActivity, profile

    stages = {"open + decode", "huffman decode", "blocks up", "image down",
              "validate", "nrgba", "jpeg quality search", "image up",
              "device search", "emit"}
    data = T.encode_to_bytes(photo(700, 540, 3), T.JPEG, 92, device="cpu")
    T.compress_bytes(None, data, T.Options(), device=cuda_device)  # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        T.compress_bytes(None, data, T.Options(), device=cuda_device)
        torch.cuda.synchronize()
    events = prof.events()
    host = {e.name for e in events
            if e.device_type == torch.autograd.DeviceType.CPU}
    device = {e.name for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA}
    assert stages <= host
    assert not stages & device, stages & device
