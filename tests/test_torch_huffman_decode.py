"""Kernel K9's plain model (ops/huffman_decode.py) against the host C++
scan decoder, and the route of codecs/jpeg.decode_jpeg through K9.

The plain model runs K9's phases (unstuff, decode from any state, the
sync rounds, the counts, the write, the DC sums) in plain Python; it must
give native.jpeg_decode_scan's blocks bit for bit, or raise its flag.
decode_jpeg takes the K9 route on a card only; here the route is switched
on for the CPU with the plain model standing in for the wrapper's launch
(k9_on_cpu), to hold the route's results and errors to the host route's.
This file does not import JAX.
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from fennec_tpu_torch.codecs import jpeg as J
from fennec_tpu_torch.ops import huffman_decode as H
from fennec_tpu_torch.ops import huffman_decode_cuda as K9

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()
SPECS = CS.k9_case_specs()


def plain_only(data: bytes, sub_bits: int = H.SUB_BITS, **kw):
    """The plain model's (blocks, flag) for a single-scan JPEG."""
    hdr = J.parse_jpeg(data)
    mx, my, _, _, specs = J._build_decode_specs(hdr)
    return H.decode_scan(data, hdr.scan_offset, specs, mx, my,
                         hdr.restart_interval, sub_bits, **kw)


def plain_decode(data: bytes, sub_bits: int = H.SUB_BITS, **kw):
    """The plain model's (blocks, flag) and the host decoder's blocks."""
    return plain_only(data, sub_bits, **kw), CS.k9_host(data)[4]


def k9_on_cpu(m, min_blocks=0, flag=None):
    """Switch decode_jpeg's K9 route on for the CPU (monkeypatch m): the
    wrapper prepares the scan as on a card, and the plain model of its
    phases stands in for the launch (`flag`, if given, for the flag it
    raises).  Returns the list of launches made, one entry each."""
    calls = []

    def launch(lay, geo, tabs, on_device, device):
        outs, got = H.decode_laid_out(lay, geo, tabs, on_device)
        calls.append(got)
        raised = got if flag is None else flag
        return K9.Decoded([torch.from_numpy(o) for o in outs],
                          K9.huffman_decode, lambda: raised)

    m.setattr(J, "_scan_on_device", lambda dev: True)
    m.setattr(K9, "MIN_BLOCKS", min_blocks)
    m.setattr(K9.huffman_decode, "_launch", launch)
    return calls


@pytest.mark.parametrize("tag,kind,w,h,ri,sub_bits,seed", SPECS,
                         ids=[s[0] for s in SPECS])
def test_plain_model_is_the_host_decoder(tag, kind, w, h, ri, sub_bits,
                                         seed):
    """Every frame, size, restart interval and subsequence length: flag 0
    and the host decoder's blocks, bit for bit."""
    data = CS.k9_jpeg(kind, w, h, ri, seed)
    (got, flag), want = plain_decode(data, sub_bits)
    assert flag == 0, H.names(flag)
    assert len(got) == len(want)
    for g, x in zip(got, want):
        assert g.dtype == np.int16 and g.shape == x.shape
        np.testing.assert_array_equal(g, x)


def layout_of(data: bytes, sub_bits: int):
    hdr = J.parse_jpeg(data)
    mx, my, _, _, specs = J._build_decode_specs(hdr)
    geo = H.geometry(specs, mx, my, hdr.restart_interval)
    return H.scan_layout(data, hdr.scan_offset, geo, sub_bits), geo, specs


def test_stuffing_crosses_subsequence_edges():
    """At 32-bit subsequences the 4:2:0 500x500 scan holds stuffed 0xFF
    bytes that end a subsequence (their 0x00 lies past the edge), and
    0xFF bytes within one; the model decodes it exactly."""
    data = CS.k9_jpeg("420", 500, 500, 0, 501)
    lay, _, _ = layout_of(data, 32)
    ff = lay.drops - 1  # the 0xFF of each stuffed pair
    ubyte = ff - np.searchsorted(lay.drops, ff)
    edge = (ubyte % 4) == 3
    assert edge.any() and (~edge).any()
    (got, flag), want = plain_decode(data, 32)
    assert flag == 0
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("sub_bits", [32, 64])
def test_short_subsequences_take_many_rounds(sub_bits):
    """Short subsequences rarely synchronise inside themselves: launch 0
    leaves CTAs whose last exit moved from their successor's guess, so a
    later launch decodes again across CTAs; then the rounds converge."""
    data = CS.k9_jpeg("444", 500, 500, 0, 77)
    lay, geo, specs = layout_of(data, sub_bits)
    sy = H.sync(H.unstuff(lay), H.decode_tables(specs), geo, lay)
    assert sy.converged
    assert sy.changed[0] >= 1
    assert lay.nsub > 10 * H.CTA


def test_rounds_that_do_not_converge_raise_the_flag():
    """Given a single launch, 32-bit subsequences leave CTAs unsynced: the
    flag says so and no block is trusted."""
    data = CS.k9_jpeg("420", 500, 500, 0, 5)
    (_, flag), _ = plain_decode(data, 32, rounds=1)
    assert flag == H.NO_SYNC


def test_a_restart_interval_starts_its_own_state():
    """Each restart interval is a segment of its own: its subsequences
    start at its first bit with u = k = 0 and DC predictors 0."""
    data = CS.k9_jpeg("420", 64, 48, 1, 3)
    lay, geo, _ = layout_of(data, 1024)
    assert lay.nseg == geo.mcus_x * geo.mcus_y
    assert (np.diff(lay.seg_first_sub) >= 1).all()
    assert (lay.seg_blocks == geo.bpm).all()
    for s in range(lay.nseg):
        j = int(lay.seg_first_sub[s])
        assert H.sub_bounds(lay, j)[:2] == (s, int(lay.seg_start[s]))
        assert H.sub_bounds(lay, j)[4]
    assert (lay.seg_start[1:] >= lay.seg_end[:-1] + 16).all()


def splice_scan(data: bytes, start: float, stop: float, fill: bytes):
    """data with the scan's bytes [start, stop) (fractions of the scan)
    replaced by fill."""
    hdr = J.parse_jpeg(data)
    n = len(data) - 2 - hdr.scan_offset
    a = hdr.scan_offset + int(start * n)
    b = hdr.scan_offset + int(stop * n)
    return data[:a] + fill + data[b:]


def drop_restarts(data: bytes) -> bytes:
    hdr = J.parse_jpeg(data)
    scan = bytearray(data[hdr.scan_offset:-2])
    out, i = bytearray(), 0
    while i < len(scan):
        if scan[i] == 0xFF and i + 1 < len(scan) and 0xD0 <= scan[i + 1] <= 0xD7:
            i += 2
            continue
        out.append(scan[i])
        i += 1
    return data[:hdr.scan_offset] + bytes(out) + data[-2:]


CORRUPT = {
    # The second half of the scan gone: the host decoder reads zeros.
    "truncated": lambda d: splice_scan(d, 0.5, 1.0, b""),
    # A run of ones longer than any code: an invalid code.
    "invalid_code": lambda d: splice_scan(d, 0.4, 0.45, b"\xff\x00" * 40),
    # Bytes cut from the middle: the blocks run short or misparse.
    "cut": lambda d: splice_scan(d, 0.3, 0.35, b""),
}


def decode_or_error(data: bytes, on_device: bool, monkeypatch):
    with monkeypatch.context() as m:
        if on_device:
            k9_on_cpu(m)
        try:
            return J.decode_jpeg(data, "cpu", 1), None
        except ValueError as e:
            return None, str(e)


@pytest.mark.parametrize("how", sorted(CORRUPT))
@pytest.mark.parametrize("kind", ["420", "gray"])
def test_corrupt_streams_raise_the_flag_and_decode_as_before(
        how, kind, monkeypatch):
    """A truncated or corrupt scan raises the flag, counts a corrupt
    fallback, and decode_jpeg then returns or raises exactly what the host
    route does."""
    data = CORRUPT[how](CS.k9_jpeg(kind, 96, 64, 0, 11))
    _, flag = plain_only(data)
    assert flag != 0
    before = dict(K9.huffman_decode.fallbacks)
    got, err = decode_or_error(data, True, monkeypatch)
    want, want_err = decode_or_error(data, False, monkeypatch)
    assert K9.huffman_decode.fallbacks["corrupt"] == before["corrupt"] + 1
    assert err == want_err
    if want is None:
        assert got is None and "corrupt JPEG scan" in err
    else:
        np.testing.assert_array_equal(got, want)


def test_missing_restart_markers_go_to_the_host(monkeypatch):
    """A restart interval whose RSTn is missing is left to the host
    decoder (counted corrupt), which raises as before."""
    data = drop_restarts(CS.k9_jpeg("444", 64, 40, 7, 13))
    lay, _, _ = layout_of(data, 1024)
    assert lay is None
    before = K9.huffman_decode.fallbacks["corrupt"]
    with monkeypatch.context() as m:
        calls = k9_on_cpu(m)
        with pytest.raises(ValueError) as err:
            J.decode_jpeg(data, "cpu", 1)
    assert K9.huffman_decode.fallbacks["corrupt"] == before + 1
    assert calls == []
    assert str(err.value) == "fennec native: corrupt JPEG scan"


def test_a_dc_size_above_16_raises_the_flag():
    """A DC table whose symbols include 17: the host decoder refuses the
    scan, K9 raises BAD_DC."""
    data = CS.k9_jpeg("gray", 32, 16, 0, 2)
    hdr = J.parse_jpeg(data)
    bits, vals = hdr.dc_tables[0]
    i = data.index(bytes([0x00]) + bytes(bits) + bytes(vals))
    size = int(abs(int(CS.k9_host(data)[4][0][0, 0]))).bit_length()
    bad = list(vals)
    bad[bad.index(size)] = 17  # the first block's DC code now says 17
    data = data[:i + 17] + bytes(bad) + data[i + 17 + len(vals):]
    _, flag = plain_only(data)
    assert flag & H.BAD_DC
    with pytest.raises(ValueError, match="corrupt JPEG scan"):
        CS.k9_host(data)


@pytest.mark.parametrize("orientation", [1, 6])
@pytest.mark.parametrize("kind", sorted(CS.K9_FRAMES))
def test_decode_jpeg_through_the_k9_route(kind, orientation, monkeypatch):
    """decode_jpeg with the K9 route on at every size (the plain model
    standing in for the launch) returns the host route's pixels, one
    launch a decode, no fallback."""
    data = CS.k9_jpeg(kind, 40, 24, 3, 9)
    want = J.decode_jpeg(data, "cpu", orientation)
    fallbacks = dict(K9.huffman_decode.fallbacks)
    calls = k9_on_cpu(monkeypatch)
    got = J.decode_jpeg(data, "cpu", orientation)
    np.testing.assert_array_equal(got, want)
    assert calls == [0]
    assert K9.huffman_decode.fallbacks == fallbacks


@pytest.mark.parametrize("name", ["progressive_1280x720.jpg",
                                  "multiscan_1280x720.jpg"])
def test_progressive_and_multiscan_keep_the_host_route(name, monkeypatch):
    data = (ROOT / "tests" / "torch_fixtures" / name).read_bytes()
    want = J.decode_jpeg(data, "cpu")
    calls = k9_on_cpu(monkeypatch)
    np.testing.assert_array_equal(J.decode_jpeg(data, "cpu"), want)
    assert calls == []


def test_small_frames_count_a_small_fallback(monkeypatch):
    """A frame below MIN_BLOCKS (as it stands: 48x32 4:2:0 is 36 blocks)
    keeps the host decoder and counts a small fallback."""
    data = CS.k9_jpeg("420", 48, 32, 0, 4)
    want = J.decode_jpeg(data, "cpu")
    assert K9.MIN_BLOCKS > 36
    calls = k9_on_cpu(monkeypatch, K9.MIN_BLOCKS)
    small = K9.huffman_decode.fallbacks["small"]
    np.testing.assert_array_equal(J.decode_jpeg(data, "cpu"), want)
    assert K9.huffman_decode.fallbacks["small"] == small + 1
    assert calls == []


def test_tables_decode_every_code():
    """Each code of the Annex K tables, at the top of a 32-bit word
    followed by any bits, gives its symbol and length; an over-full table
    is refused."""
    from fennec_tpu_torch.codecs import tables as T

    rng = np.random.default_rng(0)
    for bits, vals in ((T.DC_LUMA_BITS, T.DC_LUMA_VALS),
                       (T.AC_LUMA_BITS, T.AC_LUMA_VALS),
                       (T.DC_CHROMA_BITS, T.DC_CHROMA_VALS),
                       (T.AC_CHROMA_BITS, T.AC_CHROMA_VALS)):
        t = H._table(bytes(bits), bytes(vals))
        code = k = 0
        for length in range(1, 17):
            for _ in range(bits[length - 1]):
                tail = int(rng.integers(0, 1 << (32 - length)))
                v = (code << (32 - length)) | tail
                assert H._symbol(t, v) == (length, vals[k])
                code += 1
                k += 1
            code <<= 1
    assert H._table(bytes([3] + [0] * 15), bytes([0, 1, 2])) is None


def test_the_wrapper_agrees_with_the_kernel_source():
    """The descriptor's fields and the constants the wrapper plans with
    are those of csrc/huffman_decode.cu (the kernel is built only on the
    card)."""
    src = (ROOT / "fennec_tpu_torch" / "csrc" / "huffman_decode.cu").read_text()
    body = re.search(r"enum Desc : int \{(.*?)\};", src, re.S).group(1)
    names = [re.sub(r"\s*=.*", "", n).strip() for n in body.split(",")]
    names = [n for n in names if n]
    assert names[-1] == "dFields"
    fields = []
    for n in names[:-1]:
        field = re.sub(r"(?<!^)([A-Z])", r"_\1", n[1:]).lower()
        if field in ("comp_h", "comp_v", "comp_bw"):
            fields += [f"{field}{c}" for c in range(H.MAX_COMPS)]
        else:
            fields.append(field)
    assert fields == K9.DESC
    assert re.search(r"P\.rounds = ctas;", src)
    for name, value in (("kLutBits", H.LUT_BITS), ("kThreads", H.CTA),
                        ("kMaxComps", H.MAX_COMPS),
                        ("kMaxBpm", H.MAX_BPM), ("kPad", K9.PAD),
                        ("kChecks", H.CHECKS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name


def test_the_staged_buffer_holds_each_part_where_the_plan_says():
    data = CS.k9_jpeg("420", 300, 200, 5, 21)
    lay, geo, specs = layout_of(data, 256)
    pl = K9.plan(lay, len(geo.comps))
    assert all(v % 16 == 0 for v in list(pl.staged.values())
               + list(pl.work.values()))
    buf = np.full(pl.staged_bytes, 0xAB, np.uint8)
    K9.fill(buf, lay, geo, H.decode_tables(specs), pl)
    desc = dict(zip(K9.DESC, K9.descriptor(lay, geo, pl, False).tolist()))
    o = desc["scan"]
    assert bytes(buf[o:o + desc["scan_len"]]) == lay.scan.tobytes()
    assert desc["spans"] == -(-len(lay.scan) // H.SPAN)
    o = desc["seg_first_sub"]
    np.testing.assert_array_equal(
        buf[o:o + 4 * (lay.nseg + 1)].view(np.int32), lay.seg_first_sub)
    o = desc["flag"]
    assert buf[o:o + 12].view(np.int32).tolist() == \
        [0, len(lay.scan), lay.nsub]
    assert (desc["end_byte"], desc["nsub"]) == (o + 4, o + 8)
    o = desc["changed"]
    rounds = H.launches(lay.nsub)
    assert buf[o:o + 4 * rounds].view(np.int32).tolist() == [0] * rounds
    assert desc["nsub_max"] == lay.nsub and desc["bpm"] == 6
    assert desc["device_layout"] == 0 and desc["total_blocks"] == geo.blocks
    assert pl.work["bits"] == 0 and pl.work_bytes >= len(lay.scan) + K9.PAD


def test_decodes_again_stop_where_they_meet_the_last_one(monkeypatch):
    """A subsequence decoded again from a new start stops at the first
    checkpoint where it meets its last decode (state, block in its MCU
    and coefficient alike): the rounds step through fewer symbols than
    decoding every subsequence again in full, and end with the same
    states, counts and sums."""
    data = CS.k9_jpeg("420", 500, 500, 0, 15)
    lay, geo, specs = layout_of(data, 1024)
    bits, tabs = H.unstuff(lay), H.decode_tables(specs)
    steps = [0]
    step = H._step

    def counted(*args):
        steps[0] += 1
        return step(*args)

    monkeypatch.setattr(H, "_step", counted)
    short = H.sync(bits, tabs, geo, lay)
    n_short, steps[0] = steps[0], 0
    run = H.run
    monkeypatch.setattr(H, "run", lambda *a, **kw: run(*a[:7]))
    full = H.sync(bits, tabs, geo, lay)
    assert steps[0] > 1.15 * n_short
    assert (short.start, short.count, short.dcsum) == \
        (full.start, full.count, full.dcsum)


@pytest.mark.parametrize("cut", ["whole", "half", "invalid_code", "fill"])
@pytest.mark.parametrize("kind", sorted(CS.K9_FRAMES))
def test_the_card_finds_the_interval_the_host_would(kind, cut):
    """A scan without restart intervals is laid out on the card
    (device_layout, completed as complete_on_device models the count and
    prefix kernels): its data bits, subsequences and unstuffed bytes are
    scan_layout's, whole, cut short, with an invalid code spliced in, or
    ending on a fill byte; the grid's bound holds them."""
    data = CS.k9_jpeg(kind, 96, 64, 0, 3)
    o = J.parse_jpeg(data).scan_offset
    m = o + (len(data) - o) // 2
    data = {"whole": data, "half": data[:m],
            "invalid_code": data[:m] + b"\xff\x00" * 40 + data[m + 80:],
            "fill": data[:m] + b"\xff\xff\xd9"}[cut]
    for sub_bits in (64, 1024):
        want, geo, _ = layout_of(data, sub_bits)
        staged = H.device_layout(data, o, geo, sub_bits)
        got = H.complete_on_device(staged)
        assert got.seg_end.tolist() == want.seg_end.tolist()
        assert got.seg_first_sub.tolist() == want.seg_first_sub.tolist()
        assert got.nsub <= staged.nsub
        n = int(want.seg_end[0]) // 8
        assert H.unstuff(got)[:n] == H.unstuff(want)[:n]


def redone_by_launch(bits, tabs, geo, lay, cta, rounds, monkeypatch):
    """The decodes again (from a new start) of each of the first `rounds`
    launches, and the sync of `rounds` launches."""
    redone = [0]
    run = H.run

    def counted(*args, **kw):
        redone[0] += len(args) > 7 or "old" in kw
        return run(*args, **kw)

    per, sy = [], None
    with monkeypatch.context() as m:
        m.setattr(H, "run", counted)
        for r in range(1, rounds + 1):
            redone[0] = 0
            sy = H.sync(bits, tabs, geo, lay, cta, r)
            per.append(redone[0] - sum(per))
    return per, sy


def test_a_launch_that_decodes_again_to_the_same_exits_converges(
        monkeypatch):
    """The first launch that counts no move decodes subsequences again
    (its CTA's first took a moved exit) and the rounds end there: a
    launch counts moved exits, not decodes again."""
    data = CS.k9_jpeg("420", 96, 64, 0, 31)
    lay, geo, specs = layout_of(data, 32)
    bits, tabs = H.unstuff(lay), H.decode_tables(specs)
    full = H.sync(bits, tabs, geo, lay, 2)
    last = max(r for r, n in enumerate(full.changed) if n)
    per, sy = redone_by_launch(bits, tabs, geo, lay, 2, last + 2,
                               monkeypatch)
    assert sy.converged and sy.changed[last + 1] == 0
    assert per[last + 1] > 0
    assert not H.sync(bits, tabs, geo, lay, 2, last + 1).converged


@pytest.mark.parametrize("cta", [2, 4, 16])
def test_the_launches_converge_however_many_ctas_a_sync_crosses(cta):
    """CTAs of a few 32-bit subsequences hold far less than a guess needs
    to find the MCU position, so the sync crosses many CTAs, more than
    six launches' worth: the launches, one per CTA, still converge, and
    the blocks are the host decoder's."""
    data = CS.k9_jpeg("420", 96, 64, 0, 31)
    lay, geo, specs = layout_of(data, 32)
    bits, tabs = H.unstuff(lay), H.decode_tables(specs)
    sy = H.sync(bits, tabs, geo, lay, cta)
    assert len(sy.changed) == H.launches(lay.nsub, cta)
    assert sy.converged
    if cta == 2:
        assert sum(1 for n in sy.changed if n) > 6
    (got, flag), want = plain_decode(data, 32, cta=cta)
    assert flag == 0
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("flag,reason", [(H.NO_SYNC, "no_sync"),
                                         (H.BAD_CODE, "corrupt"),
                                         (H.SHORT | H.PAST_END, "corrupt")])
def test_a_set_flag_counts_its_reason_and_decodes_on_the_host(
        flag, reason, monkeypatch):
    """A launch whose flag is set hands the file to the host decoder
    (the host route's pixels) and counts one fallback under its reason:
    `no_sync` where the sync did not converge, `corrupt` for an anomaly
    of the scan."""
    data = CS.k9_jpeg("420", 64, 48, 0, 6)
    want = J.decode_jpeg(data, "cpu")
    before = dict(K9.huffman_decode.fallbacks)
    with monkeypatch.context() as m:
        calls = k9_on_cpu(m, flag=flag)
        got = J.decode_jpeg(data, "cpu")
    np.testing.assert_array_equal(got, want)
    assert calls == [0]
    after = dict(K9.huffman_decode.fallbacks)
    assert after.pop(reason) == before.pop(reason) + 1
    assert after == before


def without_dqt(data: bytes) -> bytes:
    """data with its first component's quantization table id 3, which no
    DQT defines."""
    at = data.index(b"\xff\xc0") + 4 + 6 + 2
    return data[:at] + b"\x03" + data[at + 1:]


@pytest.mark.parametrize("scan", ["whole", "invalid_code"])
def test_a_header_error_is_the_host_routes(scan, monkeypatch):
    """A frame whose component names a missing DQT: with a sound scan both
    routes raise the missing DQT; with an invalid code both raise the
    host decoder's scan error, which it meets first."""
    data = without_dqt(CS.k9_jpeg("420", 96, 64, 0, 12))
    if scan == "invalid_code":
        data = CORRUPT["invalid_code"](data)
    got = decode_or_error(data, True, monkeypatch)
    want = decode_or_error(data, False, monkeypatch)
    assert got[0] is None and got == want
    assert ("missing DQT" if scan == "whole" else "corrupt JPEG scan") \
        in want[1]


def test_a_flat_frame_needs_more_launches_than_six():
    """A flat grey codes every MCU alike: a guess decodes valid symbols
    out of step with the MCU and never finds its position, so the exact
    state crosses one CTA a launch.  Six launches do not converge; the
    launches, one per CTA, do, and the blocks are the host decoder's."""
    data = CS.k9_jpeg("gray", 512, 512, 0, 5, value=77)
    lay, geo, specs = layout_of(data, 32)
    bits, tabs = H.unstuff(lay), H.decode_tables(specs)
    assert not H.sync(bits, tabs, geo, lay, rounds=6).converged
    sy = H.sync(bits, tabs, geo, lay)
    assert sy.converged and sum(1 for n in sy.changed if n) >= 6
    (got, flag), want = plain_decode(data, 32)
    assert flag == 0
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
