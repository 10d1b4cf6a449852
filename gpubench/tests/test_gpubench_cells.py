"""Every cell end to end at a tiny size on the port's CPU path, the
contract's shape of BENCHMARK.json, and discovery by name."""

import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest

from tiny import CELLS, ROOT, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_and_prints_its_line(workload, traced):
    rc, line = run_cell(workload, traced=traced,
                        seconds=1.5 if traced else 0.4)
    assert rc == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    b = bench()
    if traced:
        allowed = {m["name"] for m in b["per_layer"]
                   if workload in m["workloads"]}
        assert set(line["metrics"]) <= allowed
        assert line["metrics"]  # the stage and counter readers read here
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["device"]["window_s"] > 0
    else:
        want = {m["name"] for m in b["end_to_end"]
                if workload in m.get("workloads", [workload])}
        assert set(line["metrics"]) == want
        assert all(m["value"] > 0 for m in line["metrics"].values())
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_names_units_and_keys_follow_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(b["paths"][0] + "/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    assert {c["name"] for c in b["configs"]} == {w["config"]
                                                for w in b["workloads"]}
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        traffic = os.path.join(ROOT, "gpubench", "traffic",
                               w["traffic"] + ".json")
        entry = json.load(open(traffic))["entry"]
        assert os.path.exists(os.path.join(ROOT, "gpubench", "entries",
                                           entry + ".py"))
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "gpubench", "metrics",
                                           m["name"] + ".py"))
        reports = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(reports), m["name"]
    assert 1 <= b["run_seconds"] <= 51
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


BYTES_ENTRY = """
from gpubench.harness import cells, jpeg, plain, reference
from gpubench.harness.photo import photos


class Driver(cells.Driver):
    def setup(self):
        c = self.config
        w, h, q = c["width"], c["height"], c["input_quality"]
        imgs = photos(self.traffic["distinct"], w, h, self.seed,
                      self.device, c["fine_noise"])
        self.levels = [plain.quantize(plain.forward(x[..., :3], "float64"),
                                      q) for x in imgs]
        self.files = [jpeg.write(lv, w, h, q, None) for lv in self.levels]

    def call(self, i):
        k = i % len(self.files)
        return [(k, self.system.compress_bytes(self.files[k]))]

    def bound_s(self, key, res):
        return 1e-3

    def case(self, key):
        c = self.config
        return reference.Case(
            levels=[lv.reshape(*lv.shape[:2], 64).short().numpy()
                    for lv in self.levels[key]],
            quality=c["input_quality"], size=(c["width"], c["height"]))
"""


def test_files_added_in_a_copy_are_found_by_name(tmp_path):
    """A configuration, a mix with an entry point and two clients of its
    own, and a metric, added as files and entries, are found without
    editing any file that was there."""
    shutil.copytree(os.path.join(ROOT, "gpubench"), tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    small = json.load(open(os.path.join(ROOT, "gpubench", "configs",
                                        "photo12mp.json")))
    small.update(name="photo_small", width=80, height=48)
    (tmp_path / "gpubench" / "configs" / "photo_small.json").write_text(
        json.dumps(small))
    (tmp_path / "gpubench" / "traffic" / "bytes2.json").write_text(
        json.dumps({"entry": "compress_bytes", "clients": 2, "distinct": 3,
                    "warmup": 1, "check": 2, "trace_seconds": 0.3}))
    (tmp_path / "gpubench" / "entries" / "compress_bytes.py").write_text(
        BYTES_ENTRY)
    (tmp_path / "gpubench" / "metrics" / "requests_seen.py").write_text(
        "def read(r):\n    return r.requests\n")
    b["configs"].append({"name": "photo_small", "source": "test",
                         "file": "gpubench/configs/photo_small.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "photo_small.bytes2",
                           "config": "photo_small", "traffic": "bytes2",
                           "chips": 1, "why": "test"})
    b["end_to_end"][0]["workloads"].append("photo_small.bytes2")
    b["per_layer"].append({"name": "requests_seen", "unit": "1",
                           "better": "higher", "source": "host_clock",
                           "layer": "entry points",
                           "moves": "latency_p50_ms",
                           "workloads": ["photo_small.bytes2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    rc, line = run_cell("photo_small.bytes2", traced=True, seconds=1.5,
                        root=str(tmp_path))
    assert rc == 0 and line["correct"] is True, line
    assert line["metrics"]["requests_seen"]["value"] > 0
    rc, line = run_cell("photo_small.bytes2", root=str(tmp_path))
    assert rc == 0 and line["correct"] is True, line
    assert set(line["metrics"]) == {"latency_p50_ms", "setup_s"}


def test_many_clients_lose_no_request():
    """More clients than cores, with a short switch interval: every
    request is handed out once, counted once and timed once."""
    from gpubench.harness import cells

    done = types.SimpleNamespace(jpeg_quality=50,
                                 compressed_data=b"\xff\xd8\xff\xd9")

    class Fast(cells.Driver):
        def call(self, i):
            self.calls.append(i)
            return [(i, done)]

        def bound_s(self, key, res):
            return 0.0

    clients = (os.cpu_count() or 4) + 3
    driver = Fast({"target_ssim": 0.94}, {"clients": clients, "check": 5},
                  7, "cpu", None)
    driver.calls = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        driver.measure(0.5)
    finally:
        sys.setswitchinterval(old)
        driver.close()
    n = len(driver.calls)
    assert n > clients
    assert sorted(driver.calls) == list(range(n))
    assert driver.attempted == driver.images == len(driver.latencies) == n
    assert driver.failed == 0 and len(driver.sample) == 5
    assert len({key for key, _ in driver.sample}) == 5


def test_no_jax_and_no_fennec_tpu_after_a_run():
    code = ("import sys, tiny; rc, line = tiny.run_cell("
            "'photo12mp.file'); "
            "top = {m.split('.')[0] for m in sys.modules}; "
            "print(rc, line['correct'], sorted(top & {'jax', 'jaxlib', "
            "'flax', 'fennec_tpu'}))")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(__file__))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert out.stdout.strip().splitlines()[-1] == "0 True []", out.stderr


def test_the_real_command_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "photo12mp.file",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr
