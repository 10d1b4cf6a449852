"""The port's multi-device layer (parallel/mesh, parallel/distributed,
parallel/batched's mesh functions) on the CPU.

A mesh of CPU devices (["cpu"] * n; each entry a shard of its own, run
in a thread of its own) stands in for the cards, as the JAX package's
tests use 8 virtual CPU devices (tests/conftest.py).  Every *_sharded
function on 1 to 4 shards equals its unsharded form in the port: the
same qualities, found flags and bytes, SSIM bit for bit.  Against the
JAX functions on tests/test_parallel.py's inputs, with JAX on its
data_mesh(8): the same qualities and found flags, SSIM within 1e-5, the
same scan bytes after finalize_scan_host.  The card is faked only where
a rule reads how many cards there are (torch.cuda.device_count).
"""

import socket
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import make_noise_image
from fennec_tpu.ops.jpeg_emit import finalize_scan_host as j_finalize
from fennec_tpu.parallel import batched as jpb
from fennec_tpu.parallel.mesh import data_mesh as j_data_mesh
from fennec_tpu_torch import device as tdevice
from fennec_tpu_torch import parallel as tpar
from fennec_tpu_torch.ops import jpeg_emit_cuda as k3
from fennec_tpu_torch.ops.ssim_cuda import ssim_window
from fennec_tpu_torch.parallel import batched as tpb
from fennec_tpu_torch.parallel import distributed as tdist
from fennec_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

SSIM_ATOL = 1e-5
SHARDS = [1, 2, 3, 4]


def batch_of_images(b, w, h):
    """tests/test_parallel.py's inputs."""
    return np.stack([make_noise_image(w, h, seed=i) for i in range(b)])


def cpu_mesh(n):
    return tmesh.DataMesh(("cpu",) * n)


@pytest.fixture
def cards(monkeypatch):
    """Pretend PyTorch sees `n` cards (for the rules that count them)."""
    def set_count(n):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.delenv("FENNEC_MESH", raising=False)
    return set_count


# ── Mesh construction ───────────────────────────────────────────────────────


def test_explicit_mesh_may_repeat_a_device():
    mesh = tmesh.DataMesh(["cpu", "cpu", torch.device("cpu")])
    assert mesh.size == 3 and mesh.axis_names == ("data",)
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.distinct() == [torch.device("cpu")]


@pytest.mark.parametrize("devices", [
    (),                  # no device
    ("cpu", "cuda:0"),   # two kinds of device
    ("meta",),           # not a CPU or a card
])
def test_bad_mesh_raises(devices):
    with pytest.raises(ValueError):
        tmesh.DataMesh(devices)


def test_make_mesh_shapes():
    mesh = tmesh.make_mesh((2,), ("data",), ["cpu"] * 3)
    assert mesh.size == 2 and mesh.axis_names == ("data",)


@pytest.mark.parametrize("sizes,names", [((16,), ("data",)),
                                         ((4, 2), ("data", "spatial")),
                                         ((2,), ("spatial",))])
def test_make_mesh_raises(sizes, names):
    # More devices than exist (JAX mesh.py:19), or a shape not ported.
    with pytest.raises(ValueError):
        tmesh.make_mesh(sizes, names, ["cpu"] * 8)


def test_data_mesh_over_the_visible_cards(cards):
    cards(4)
    assert tmesh.data_mesh().devices == tuple(
        torch.device("cuda", i) for i in range(4))
    assert tmesh.data_mesh(2).size == 2
    assert tdist.global_data_mesh().size == 4
    with pytest.raises(ValueError):
        tmesh.data_mesh(5)


@pytest.mark.parametrize("b,n", [(0, 2), (2, 3), (3, 3), (7, 4), (100, 3),
                                 (1, 1), (65, 8)])
def test_shard_rows_cover_each_row_once_in_order(b, n):
    ranges = tmesh.shard_rows(b, cpu_mesh(n))
    assert len(ranges) == n
    rows = [r for start, stop in ranges for r in range(start, stop)]
    assert rows == list(range(b))
    sizes = [stop - start for start, stop in ranges]
    assert max(sizes) - min(sizes) <= 1
    assert sizes == sorted(sizes, reverse=True)


# ── The production rule (parallel/batched.data_mesh, resolve_mesh) ──────────


@pytest.mark.parametrize("device,count,flag,want", [
    (None, 4, "", 4),              # every card of a node
    ("cuda", 2, "", 2),            # a bare "cuda" is the default too
    (None, 4, "0", None),          # FENNEC_MESH=0 turns it off
    (None, 1, "", None),           # one card: the unsharded path
    (None, 1, "1", None),          # FENNEC_MESH=1 forces nothing more
    (None, 0, "1", None),          # no card, the CPU backend
    ("cuda:1", 4, "", None),       # the caller named one card
    ("cpu", 4, "", None),          # or the CPU
    (torch.device("cuda", 0), 4, "", None),
    (["cpu", "cpu"], 0, "0", 2),   # an explicit sequence is honoured
    (("cpu",), 0, "", 1),
])
def test_data_mesh_rule(cards, monkeypatch, device, count, flag, want):
    cards(count)
    if flag:
        monkeypatch.setenv("FENNEC_MESH", flag)
    mesh = tpb.data_mesh(device)
    assert (None if mesh is None else mesh.size) == want
    assert (tdevice.resolve_mesh(device) is None) == (want is None)


def test_explicit_cards_need_a_card(cards):
    cards(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpb.data_mesh(["cuda:0", "cuda:0"])


def test_explicit_cards_must_exist(cards):
    cards(2)
    assert tpb.data_mesh(["cuda:1", "cuda", "cuda:1"]).devices == (
        torch.device("cuda", 1), torch.device("cuda", 0),
        torch.device("cuda", 1))
    with pytest.raises(ValueError, match="does not exist"):
        tpb.data_mesh(["cuda:0", "cuda:2"])


def test_single_image_entry_points_refuse_a_mesh():
    with pytest.raises(ValueError, match="one device"):
        tdevice.resolve(["cpu", "cpu"])


# ── shard_data_call ─────────────────────────────────────────────────────────


def test_shard_data_call_splits_and_concatenates_in_order():
    seen = []
    lock = threading.Lock()

    def fn(rows, labels, extra):
        with lock:
            seen.append((threading.current_thread().name, rows.shape[0]))
        return (rows * 2, np.array([int(x) for x in labels]) + extra)

    rows = torch.arange(10)
    labels = [str(i) for i in range(10)]
    got = tpb.shard_data_call(cpu_mesh(3), fn, rows, labels, 100,
                              replicated=1)
    assert torch.equal(got[0], rows * 2)
    np.testing.assert_array_equal(got[1], np.arange(10) + 100)
    assert sorted(n for _, n in seen) == [3, 3, 4]
    assert len({name for name, _ in seen}) == 3  # a thread per shard


def test_one_shard_runs_on_the_calling_thread():
    names = []
    tpb.shard_data_call(cpu_mesh(4), lambda x: names.append(
        threading.current_thread().name) or x, np.arange(1))
    assert names == [threading.current_thread().name]


def test_a_failed_shard_raises_after_every_shard_stopped():
    finished = []

    def fn(rows):
        if int(rows[0]) == 0:
            raise RuntimeError("shard 0 failed")
        time.sleep(0.2)
        finished.append(int(rows[0]))
        return rows

    with pytest.raises(RuntimeError, match="shard 0 failed"):
        tpb.shard_data_call(cpu_mesh(3), fn, torch.arange(6))
    assert sorted(finished) == [2, 4]


def test_host_scans_concatenate():
    imgs = batch_of_images(5, 24, 16)
    whole = tpb.batched_search_emit(imgs, [0.9] * 5)[3]
    parts = [tpb.batched_search_emit(imgs[a:b], [0.9] * (b - a))[3]
             for a, b in ((0, 2), (2, 3), (3, 5))]
    joined = tpb.HostScans.concat(parts)
    np.testing.assert_array_equal(joined.base, whole.base)
    assert [joined.scan(j) for j in range(5)] == \
        [whole.scan(j) for j in range(5)]


# ── The *_sharded functions against their unsharded forms ───────────────────


@pytest.mark.parametrize("n", SHARDS)
def test_quality_search_sharded_matches_unsharded(n):
    imgs = batch_of_images(5, 48, 40).astype(np.float32)
    targets = [0.90, 0.94, 0.97, 0.85, 0.99]
    q1, s1, f1 = tpb.batched_quality_search(imgs, targets)
    q2, s2, f2 = tpb.batched_quality_search_sharded(cpu_mesh(n), imgs,
                                                    targets)
    assert torch.equal(q1, q2) and torch.equal(f1, f2)
    assert torch.equal(s1, s2)  # bit for bit


@pytest.mark.parametrize("n", SHARDS)
def test_search_emit_sharded_matches_unsharded(n):
    imgs = batch_of_images(6, 48, 32)
    targets = np.full(6, 0.90, np.float32)
    q1, s1, f1, scans1 = tpb.batched_search_emit(imgs, targets)
    q2, s2, f2, scans2 = tpb.batched_search_emit_sharded(cpu_mesh(n), imgs,
                                                         targets)
    np.testing.assert_array_equal(q1, q2)
    np.testing.assert_array_equal(f1, f2)
    assert s1.tobytes() == s2.tobytes()
    assert [scans1.scan(j) for j in range(6)] == \
        [scans2.scan(j) for j in range(6)]


@pytest.mark.parametrize("n", SHARDS)
def test_size_search_sharded_matches_unsharded(n):
    imgs = batch_of_images(5, 48, 48)
    q1, f1 = tpb.batched_size_search(imgs, 900, 1, 100)
    q2, f2 = tpb.batched_size_search_sharded(cpu_mesh(n), imgs, 900, 1, 100)
    assert torch.equal(q1, q2) and torch.equal(f1, f2)


@pytest.mark.parametrize("n", SHARDS)
def test_ssim_sharded_matches_unsharded(n):
    a = batch_of_images(5, 40, 36).astype(np.float32)
    b = np.clip(a + 9.0, 0, 255)
    want = tpb.batched_ssim(torch.from_numpy(a), torch.from_numpy(b))
    got = tpb.batched_ssim_sharded(cpu_mesh(n), a, b)
    assert torch.equal(got, want)


def test_ssim_sharded_has_no_spatial_axis():
    a = batch_of_images(2, 32, 32).astype(np.float32)
    with pytest.raises(ValueError, match="spatial"):
        tpb.batched_ssim_sharded(cpu_mesh(2), a, a, spatial=True)


# ── Against the JAX package, JAX on its data_mesh(8) ───────────────────────


def test_quality_search_sharded_matches_jax():
    imgs = batch_of_images(8, 32, 32).astype(np.float32)
    targets = np.full(8, 0.90, np.float32)
    jq, js, jf = jpb.batched_quality_search_sharded(
        j_data_mesh(8), jnp.asarray(imgs), jnp.asarray(targets))
    q, s, f = tpar.batched_quality_search_sharded(cpu_mesh(3), imgs, targets)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=SSIM_ATOL)


def test_search_emit_sharded_matches_jax():
    imgs = batch_of_images(8, 48, 32).astype(np.float32)
    targets = np.full(8, 0.90, np.float32)
    jq, _js, jf, jw, jb = jpb.batched_search_emit_sharded(
        j_data_mesh(8), jnp.asarray(imgs), jnp.asarray(targets), True, 2048)
    q, _s, f, scans = tpb.batched_search_emit_sharded(cpu_mesh(3), imgs,
                                                      targets)
    np.testing.assert_array_equal(q, np.asarray(jq))
    np.testing.assert_array_equal(f, np.asarray(jf))
    jw, jb = np.asarray(jw), np.asarray(jb)
    for j in range(8):
        assert scans.scan(j) == j_finalize(jw[j], int(jb[j]))


def test_size_search_sharded_matches_jax():
    imgs = batch_of_images(8, 48, 48)
    jq, jf = jpb.batched_size_search_sharded(j_data_mesh(8), imgs, 900, 1,
                                             100)
    q, f = tpb.batched_size_search_sharded(cpu_mesh(3), imgs, 900, 1, 100)
    jq, jf = np.asarray(jq), np.asarray(jf)
    np.testing.assert_array_equal(f.numpy(), jf)
    np.testing.assert_array_equal(q.numpy()[jf], jq[jf])


def test_ssim_sharded_matches_jax():
    a = batch_of_images(8, 32, 32).astype(np.float32)
    b = np.clip(a + 10.0, 0, 255)
    want = np.asarray(jpb.batched_ssim_sharded(j_data_mesh(8),
                                               jnp.asarray(a),
                                               jnp.asarray(b)))
    got = tpb.batched_ssim_sharded(cpu_mesh(3), a, b).numpy()
    np.testing.assert_allclose(got, want, atol=SSIM_ATOL)


# ── Counts and state shared by shard threads ───────────────────────────────


@pytest.mark.parametrize("kernel", [ssim_window, k3.block_stats, k3.deposit,
                                    k3.quantize_count, k3.size_bisect],
                         ids=["K1", "K3a", "K3b", "K4", "K4_bisection"])
def test_launch_counts_survive_shard_threads(kernel):
    """Shard threads count their launches into one counter: none may be
    lost (K2's count shares K1's lock pattern; the card tests count it
    under a real mesh)."""
    start = kernel.launches
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def fn(rows):
            for _ in range(2000):
                kernel.count_launch()
            return rows

        tpb.shard_data_call(cpu_mesh(8), fn, torch.arange(8))
    finally:
        sys.setswitchinterval(old)
    assert kernel.launches - start == 16000
    kernel.launches = start


# ── initialize_distributed ──────────────────────────────────────────────────


@pytest.fixture
def no_cluster(monkeypatch):
    for key in tdist.CLUSTER_ENV:
        monkeypatch.delenv(key, raising=False)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_initialize_without_an_environment_does_nothing(no_cluster):
    tdist.initialize_distributed()
    assert not dist.is_initialized()


def test_initialize_when_already_initialized_does_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("init_process_group called again")

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "init_process_group", refuse)
    tdist.initialize_distributed("localhost:1", 2, 0)


@pytest.mark.parametrize("args", [
    ("localhost:29500", 2, 5),     # a rank outside the world
    ("localhost:29500", 2, -1),
    ("localhost", 1, 0),           # no port
    (":29500", 1, 0),              # no host
    ("localhost:29500", None, 0),  # a part of the configuration
    (None, 1, 0),
])
def test_initialize_rejects_a_bad_explicit_configuration(no_cluster, args):
    with pytest.raises(ValueError):
        tdist.initialize_distributed(*args)
    assert not dist.is_initialized()


def test_initialize_explicit_single_process(no_cluster):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    tdist.initialize_distributed(f"localhost:{port}", 1, 0)
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert dist.get_backend() == "gloo"
    tdist.initialize_distributed(f"localhost:{port}", 1, 0)  # no-op now
