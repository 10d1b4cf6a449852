"""The tile plans of kernels K7 (csrc/decode_recon.cu) and K8's DCT
(csrc/forward_dct.cu) in plain Python, where there is no card.

The wrappers carry each kernel's plan: the TMA bulk copies that fill a
stage (ops/decode_recon_cuda.stage_copies, ops/forward_dct_cuda
.stage_rows), the register tiles of the product (register_tile) and the
k-major buffers (kmajor_index).  These tests hold the plans to what the
kernels need: every block or pixel copied once, every span 16-byte aligned
with a size that is a multiple of 16 and inside its tensor, every (block,
output) sum held by one lane, and each warp's shared-memory accesses on
distinct banks or a broadcast (as few wavefronts as their bytes allow).
K7's colour pass stores at every EXIF orientation (store_map,
colour_units): every output pixel once at its upright place, a warp store
in whole 32-byte sectors.
tests/test_torch_decode_fdct.py walks whole tiles with the same plans
against the plain versions.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from fennec_tpu_torch.ops import decode_recon_cuda as k7
from fennec_tpu_torch.ops import forward_dct_cuda as k8

WARPS = 8


def wavefronts(addrs, width: int) -> int:
    """Wavefronts of one warp's shared-memory access: `addrs` the word
    address of each lane, `width` 32-bit words each.  A bank serves one
    distinct word a wavefront; lanes reading the same word share it."""
    words = {a + i for a in addrs for i in range(width)}
    return max(Counter(wd % 32 for wd in words).values())


def least(addrs, width: int) -> int:
    """The fewest wavefronts the access's distinct words need."""
    return -(-len({a + i for a in addrs for i in range(width)}) // 32)


# ── K7 ──────────────────────────────────────────────────────────────────────

SAMPLINGS = {
    "gray": [(1, 1)],
    "420": [(2, 2), (1, 1), (1, 1)],
    "422": [(2, 1), (1, 1), (1, 1)],
    "444": [(1, 1), (1, 1), (1, 1)],
    "ycck_420": [(2, 2), (1, 1), (1, 1), (2, 2)],
    "cmyk": [(1, 1)] * 4,
}


def frame_comps(sampling, h: int, w: int):
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    return ([k7.Component(a, b, mx * a, my * b) for a, b in sampling], hmax,
            vmax, mx, my)


def k7_walk_copies(comps, mx: int, my: int, nimg: int, strides, tsel,
                   tab_stride: int, bases, sizes, tab_size: int):
    """Every tile's copies: asserts each is aligned, a multiple of 16
    bytes, inside its tensor and inside the stage; returns how many times
    each component's blocks (per image) were copied."""
    tile, tiles_x = k7.tile_plan(comps, mx)
    seen = [np.zeros((nimg, c.bw * c.bh), np.int64) for c in comps]
    for img in range(nimg):
        for ty in range(my):
            for tx in range(tiles_x):
                mx0 = tx * tile
                nm = min(tile, mx - mx0)
                slots = np.zeros(k7.TILE_BLOCKS * 128 + 1024, np.int64)
                for src, off, nbytes, dst in k7.stage_copies(
                        comps, strides, tsel, tab_stride, img, ty, mx0, nm):
                    base, size = ((0, tab_size) if src == "tables"
                                  else (bases[src], sizes[src]))
                    assert (base + off) % 16 == 0 and nbytes % 16 == 0
                    assert nbytes > 0 and 0 <= off and off + nbytes <= size
                    assert dst % 16 == 0 and dst + nbytes <= slots.size
                    slots[dst:dst + nbytes] += 1
                    if src != "tables":
                        b0 = off // 128 - img * strides[src]
                        seen[src][img, b0:b0 + nbytes // 128] += 1
                assert (slots <= 1).all(), "stage bytes written twice"
                nblk = k7.slot_base(comps, nm)[-1]
                assert (slots[:nblk * 128] == 1).all()
    return seen


@pytest.mark.parametrize("kind", sorted(SAMPLINGS))
@pytest.mark.parametrize("hw", [(27, 347), (8, 8), (17, 9), (40, 2100)])
def test_k7_frame_copies_cover_every_block_once(kind, hw):
    """A frame's components (each its own tensor): every block of every
    component in exactly one tile's copy; the table rows of the frame."""
    h, w = hw
    comps, hmax, vmax, mx, my = frame_comps(SAMPLINGS[kind], h, w)
    sizes = [c.bw * c.bh * 128 for c in comps]
    seen = k7_walk_copies(comps, mx, my, 1, [0] * len(comps),
                          list(range(len(comps))), 64, [0] * len(comps),
                          sizes, len(comps) * 256)
    assert all((s == 1).all() for s in seen)


@pytest.mark.parametrize("sub", [True, False])
@pytest.mark.parametrize("hw", [(37, 45), (500, 500), (16, 8)])
def test_k7_batch_copies_cover_every_block_once(sub, hw):
    """The batch entry's (B, NT, 64) chunk: the components are row slices
    of one tensor (Cb at ny blocks, Cr at ny + nc), image i at i * NT;
    every block of every image copied once, every span aligned and inside
    the chunk; the (B, 2, 64) tables at 128 ints an image."""
    h, w = hw
    s = 2 if sub else 1
    mx, my = -(-w // (8 * s)), -(-h // (8 * s))
    comps = [k7.Component(s, s, mx * s, my * s), k7.Component(1, 1, mx, my),
             k7.Component(1, 1, mx, my)]
    ny, nc = mx * s * my * s, mx * my
    nt, bsz = ny + 2 * nc, 3
    bases = [0, ny * 128, (ny + nc) * 128]
    size = bsz * nt * 128
    seen = k7_walk_copies(comps, mx, my, bsz, [nt] * 3, [0, 1, 1], 128,
                          bases, [size - b for b in bases], bsz * 512)
    assert all((x == 1).all() for x in seen)


def test_k7_register_tiles_cover_every_sum_once():
    """The product's lanes hold each (slot, output) of a tile's
    TILE_BLOCKS slots once, a warp its WARP_BLOCKS slots."""
    held = Counter()
    for warp in range(WARPS):
        for lane in range(32):
            slots, outs = k7.register_tile(warp, lane)
            assert all(warp * k7.WARP_BLOCKS <= b < (warp + 1)
                       * k7.WARP_BLOCKS for b in slots)
            held.update((b, o) for b in slots for o in outs)
    assert set(held) == {(b, o) for b in range(k7.TILE_BLOCKS)
                         for o in range(64)}
    assert set(held.values()) == {1}


def test_k7_conversion_lanes_and_stores():
    """Each warp converts exactly its own slots (eight parts each, once);
    every store of a warp into the k-major buffer hits 32 banks, and the
    16-byte reads of the stage are contiguous a quarter-warp."""
    for warp in range(WARPS):
        got = Counter()
        for step in range(k7.WARP_BLOCKS // 4):
            lanes = k7.conversion_lanes(warp, step)
            got.update(lanes)
            reads = [b * 32 + part * 4 for b, part in lanes]  # int16 stage
            assert wavefronts(reads, 4) == least(reads, 4) == 4
            for j in range(8):
                words = [k7.kmajor_index(part * 8 + j, b) for b, part in lanes]
                assert wavefronts(words, 1) == 1
        assert set(got) == {(b, p) for b in range(warp * k7.WARP_BLOCKS,
                                                  (warp + 1) * k7.WARP_BLOCKS)
                            for p in range(8)}
        assert set(got.values()) == {1}
    cells = [k7.kmajor_index(k, b) for k in range(64)
             for b in range(k7.TILE_BLOCKS)]
    assert sorted(cells) == list(range(64 * k7.TILE_BLOCKS))


@pytest.mark.parametrize("k", range(64))
def test_k7_product_loads_broadcast(k):
    """Per k a warp makes three 16-byte loads: its blocks' coefficients
    (4 addresses, 16-byte aligned) and two of the matrix row (8 each),
    each one wavefront: 32 warp-FMAs for 3 wavefronts."""
    for warp in range(WARPS):
        coef, ma, mb = [], [], []
        for lane in range(32):
            slots, outs = k7.register_tile(warp, lane)
            a = k7.kmajor_index(k, slots[0])
            assert a % 4 == 0
            assert [k7.kmajor_index(k, b) for b in slots] == [a + i for i in
                                                              range(4)]
            coef.append(a)
            ma.append(k * 64 + outs[0])
            mb.append(k * 64 + outs[4])
        for addrs in (coef, ma, mb):
            assert wavefronts(addrs, 4) == least(addrs, 4) == 1


def test_k7_pixel_buffer_accesses():
    """The + 128 stores (4 slots x 16 bytes a lane) take the 4 wavefronts
    their 512 bytes need, and the colour pass's reads of a pixel row (a
    lane a column) hit distinct banks or broadcast, for every sampling."""
    for warp in range(WARPS):
        for i in range(4):
            for half in (0, 4):
                addrs = []
                for lane in range(32):
                    slots, outs = k7.register_tile(warp, lane)
                    addrs.append(k7.pixel_index(slots[i], outs[half]))
                assert all(a % 4 == 0 for a in addrs)
                assert wavefronts(addrs, 4) == least(addrs, 4) == 4
    for kind, sampling in SAMPLINGS.items():
        comps, hmax, vmax, mx, _my = frame_comps(sampling, 64, 4032)
        tile, _t = k7.tile_plan(comps, mx)
        base = k7.slot_base(comps, tile)
        for c, comp in enumerate(comps):
            rows, cols = k7.sample_offsets(comp, hmax, vmax, tile)
            for ly in range(8 * vmax):
                for x0 in range(0, len(cols) - 31, 32):
                    addrs = [base[c] * k7.PIX_STRIDE + rows[ly] + cols[x]
                             for x in range(x0, x0 + 32)]
                    assert wavefronts(addrs, 1) == least(addrs, 1), kind


def test_k7_column_offsets_fit_their_fields():
    """The colour pass keeps every component's column offset of a pixel
    column in a 16-bit field of one 64-bit word (colx): for every sampling
    and the widest tile, each offset lies inside the pixel buffer and below
    2 ** 16."""
    for kind, sampling in SAMPLINGS.items():
        comps, hmax, vmax, mx, _my = frame_comps(sampling, 64, 40000)
        tile, _t = k7.tile_plan(comps, mx)
        for comp in comps:
            _rows, cols = k7.sample_offsets(comp, hmax, vmax, tile)
            assert len(cols) <= k7.MAX_TILE_COLS
            assert max(cols) < min(2 ** 16,
                                   k7.TILE_BLOCKS * k7.PIX_STRIDE), kind


# ── K7's stores at an EXIF orientation ─────────────────────────────────────

STORE_SAMPLINGS = ["gray", "444", "422", "420"]


def test_k7_store_map_is_apply_orientation():
    """orient_plain (the CPU route's turn) is exif.apply_orientation bit
    for bit, and store_map sends pixel (y, x) where orient_plain does, at
    every orientation."""
    from fennec_tpu_torch.exif import apply_orientation

    rng = np.random.default_rng(5)
    for h, w in ((5, 7), (16, 9), (1, 3), (8, 8)):
        img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        idx = torch.arange(h * w).reshape(h, w)
        ys, xs = np.divmod(np.arange(h * w), w)
        for o in range(1, 9):
            want = apply_orientation(img, o)
            got = k7.orient_plain(torch.from_numpy(img), o).numpy()
            np.testing.assert_array_equal(got, want)
            smap = k7.store_map(o, h, w)
            assert want.shape[:2] == (smap.oh, smap.ow)
            assert smap.kind == (k7.IDENTITY if o == 1 else
                                 k7.TRANSPOSE if o >= 5 else k7.FLIP)
            placed = k7.orient_plain(idx, o).reshape(-1).numpy()
            at = smap.c0 + ys * smap.sy + xs * smap.sx
            assert (placed[at] == np.arange(h * w)).all()


def k7_oriented_stores(kind: str, h: int, w: int, orientation: int):
    """(store map, every warp store of the colour pass over every tile of
    an h x w frame: the frame pixel (y, x) of each lane, None if idle)."""
    comps, hmax, vmax, mx, my = frame_comps(SAMPLINGS[kind], h, w)
    tile, tiles_x = k7.tile_plan(comps, mx)
    smap = k7.store_map(orientation, h, w)
    stores = []
    for ty in range(my):
        for tx in range(tiles_x):
            y0, x0 = ty * 8 * vmax, tx * tile * 8 * hmax
            nm = min(tile, mx - tx * tile)
            trows, tcols = min(8 * vmax, h - y0), min(nm * 8 * hmax, w - x0)
            for warp in range(WARPS):
                for lanes in k7.colour_units(smap.kind, trows, tcols, warp):
                    assert len(lanes) == 32
                    stores.append([None if p is None else
                                   (y0 + p[0], x0 + p[1]) for p in lanes])
    return smap, stores


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("kind", STORE_SAMPLINGS)
@pytest.mark.parametrize("hw", [(27, 347), (17, 9), (40, 2100), (48, 64),
                                (64, 344)])
def test_k7_oriented_stores_cover_every_pixel_once(orientation, kind, hw):
    """Every output pixel written exactly once, by the lane holding the
    frame pixel that orientation puts there; on a frame of whole 8 x 8
    blocks each warp store fills whole 32-byte sectors (the fewest its
    bytes need: a run of 8 pixels of one output row per 8 lanes when the
    orientation transposes)."""
    h, w = hw
    smap, stores = k7_oriented_stores(kind, h, w, orientation)
    want = k7.orient_plain(torch.arange(h * w).reshape(h, w),
                           orientation).reshape(-1).numpy()
    written = np.zeros(h * w, np.int64)
    aligned = h % 8 == 0 and w % 8 == 0
    for lanes in stores:
        live = [p for p in lanes if p is not None]
        assert live, "a warp store with no pixel"
        at = [smap.c0 + y * smap.sy + x * smap.sx for y, x in live]
        for (y, x), a in zip(live, at):
            assert 0 <= y < h and 0 <= x < w
            assert want[a] == y * w + x
            written[a] += 1
        if aligned:
            assert len({a * 4 // 32 for a in at}) == -(-len(at) // 8)
    assert (written == 1).all()


@pytest.mark.parametrize("kind", STORE_SAMPLINGS)
def test_k7_transposed_colour_reads(kind):
    """The transposing colour pass reads each component's samples of a
    warp's 8 x 4 pixels (rows 8 apart in the pixel buffer) in at most two
    wavefronts: 8 rows of a block span 64 words, two rounds of the 32
    banks."""
    comps, hmax, vmax, mx, _my = frame_comps(SAMPLINGS[kind], 64, 4032)
    tile, _t = k7.tile_plan(comps, mx)
    base = k7.slot_base(comps, tile)
    for warp in range(WARPS):
        for lanes in k7.colour_units(k7.TRANSPOSE, 8 * vmax,
                                     tile * 8 * hmax, warp):
            for c, comp in enumerate(comps):
                rows, cols = k7.sample_offsets(comp, hmax, vmax, tile)
                addrs = [base[c] * k7.PIX_STRIDE + rows[ly] + cols[lx]
                         for ly, lx in lanes]
                assert wavefronts(addrs, 1) <= 2, kind


# ── K8's DCT ────────────────────────────────────────────────────────────────


def k8_walk(h: int, w: int, sub: bool, bsz: int, img_stride: int,
            view_offset: int, tensor_bytes: int):
    """Every tile's row copies of a (bsz, h, w, 4) float32 view at byte
    `view_offset` of a tensor of `tensor_bytes`, image i at i * img_stride
    floats: asserts each is aligned, a multiple of 16 bytes, inside the
    tensor and inside the stage; returns how often each pixel was copied."""
    mcu = 16 if sub else 8
    mcus_x, mcus_y = -(-w // mcu), -(-h // mcu)
    tile = k8.tile_mcus(sub, mcus_x)
    assert mcu * tile * mcu * 16 <= k8.STAGE_BYTES
    assert tile * (6 if sub else 3) <= k8.TILE_BLOCKS
    seen = np.zeros((bsz, h, w), np.int64)
    for img in range(bsz):
        for my in range(mcus_y):
            for mx0 in range(0, mcus_x, tile):
                stage = np.zeros(k8.STAGE_BYTES, np.int64)
                for src, nbytes, dst in k8.stage_rows(h, w, sub, img_stride,
                                                      img, my, mx0, tile):
                    at = view_offset + src
                    assert at % 16 == 0 and nbytes % 16 == 0 and nbytes > 0
                    assert 0 <= at and at + nbytes <= tensor_bytes
                    assert dst % 16 == 0 and dst + nbytes <= k8.STAGE_BYTES
                    stage[dst:dst + nbytes] += 1
                    pix = src // 16 - img * img_stride // 4
                    y, x = divmod(pix, w)
                    seen[img, y, x:x + nbytes // 16] += 1
                assert (stage <= 1).all()
    return seen


@pytest.mark.parametrize("sub", [True, False])
@pytest.mark.parametrize("hw", [(3024, 40), (37, 93), (5, 3), (8, 8),
                                (16, 1000), (21, 347)])
def test_k8_row_copies_cover_every_pixel_once(sub, hw):
    """Whole images, ragged on the right and at the bottom: every pixel
    of every image copied by exactly one tile."""
    h, w = hw
    seen = k8_walk(h, w, sub, 2, h * w * 4, 0, 2 * h * w * 16)
    assert (seen == 1).all()


@pytest.mark.parametrize("sub", [True, False])
@pytest.mark.parametrize("band", [(0, 96), (96, 200), (200, 299)])
def test_k8_row_copies_of_a_band_view(sub, band):
    """A band of rows of a batch is a view (rows contiguous, the image
    stride of the whole image): its copies stay inside the batch's
    tensor and cover the band's pixels once."""
    full_h, w, bsz = 299, 131, 2
    r0, r1 = band
    seen = k8_walk(r1 - r0, w, sub, bsz, full_h * w * 4, r0 * w * 16,
                   bsz * full_h * w * 16)
    assert (seen == 1).all()


def test_k8_register_tiles_cover_every_sum_once():
    held = Counter()
    for warp in range(WARPS):
        for lane in range(32):
            blks, cols = k8.register_tile(warp, lane)
            assert all(warp * k8.WARP_BLOCKS <= b < (warp + 1)
                       * k8.WARP_BLOCKS for b in blks)
            held.update((b, o) for b in blks for o in cols)
    assert set(held) == {(b, o) for b in range(k8.TILE_BLOCKS)
                         for o in range(64)}
    assert set(held.values()) == {1}


@pytest.mark.parametrize("p", range(64))
def test_k8_product_loads_broadcast(p):
    """Per pixel p a warp loads its blocks' samples (2 addresses, 16-byte
    aligned: one wavefront) and a row of the transposed matrix (16
    addresses: the two wavefronts its 256 bytes need)."""
    for warp in range(WARPS):
        samples, matrix = [], []
        for lane in range(32):
            blks, cols = k8.register_tile(warp, lane)
            a = k8.kmajor_index(p, blks[0])
            assert a % 4 == 0
            assert [k8.kmajor_index(p, b) for b in blks] == [a + i for i in
                                                             range(4)]
            samples.append(a)
            matrix.append(p * 64 + cols[0])
        assert wavefronts(samples, 4) == least(samples, 4) == 1
        assert wavefronts(matrix, 4) == least(matrix, 4) == 2


@pytest.mark.parametrize("nm", [1, 4, 7, 10, 21])
def test_k8_conversion_stores_spread(nm):
    """The conversion's stores into the k-major buffer, a warp of
    adjacent pixels (4:4:4) or quads (4:2:0) at a time.  Every (sample,
    block) of the tile has a cell of its own.  Rotations in multiples of
    4 (which keep the product's 16-byte loads whole) give one block's
    lanes 8 banks, so a store takes at most 4 wavefronts; a warp inside
    one row of at least four blocks stores 4:4:4 and the 4:2:0 chroma in
    one wavefront, the 4:2:0 luma in at most two."""
    cells = [k8.kmajor_index(p, b) for p in range(64)
             for b in range(k8.TILE_BLOCKS)]
    assert sorted(cells) == list(range(64 * k8.TILE_BLOCKS))
    if nm <= 10:  # 4:2:0
        quads = [(i // (nm * 8), i % (nm * 8)) for i in range(8 * nm * 8)]
        for w0 in range(0, len(quads), 32):
            lanes = quads[w0:w0 + 32]
            one_row = len({qy for qy, _qx in lanes}) == 1
            for dy in (0, 1):
                for dx in (0, 1):
                    ys = []
                    for qy, qx in lanes:
                        py, px = 2 * qy + dy, 2 * (qx & 7) + dx
                        blk = (qx >> 3) * 4 + (py >> 3) * 2 + (px >> 3)
                        ys.append(k8.kmajor_index((py & 7) * 8 + (px & 7),
                                                  blk))
                    assert wavefronts(ys, 1) <= (2 if one_row else 4)
            for k in (4, 5):
                cs = [k8.kmajor_index(qy * 8 + (qx & 7), k * nm + (qx >> 3))
                      for qy, qx in lanes]
                assert wavefronts(cs, 1) <= (1 if one_row else 4)
    pixels = [(i // (nm * 8), i % (nm * 8)) for i in range(8 * nm * 8)]
    for w0 in range(0, len(pixels), 32):
        lanes = pixels[w0:w0 + 32]
        one_row = len({py for py, _px in lanes}) == 1
        for k in range(3):
            addrs = [k8.kmajor_index(py * 8 + (px & 7), k * nm + (px >> 3))
                     for py, px in lanes]
            assert wavefronts(addrs, 1) <= (1 if one_row else 4)
