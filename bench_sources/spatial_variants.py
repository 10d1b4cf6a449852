"""Time how quality_search_spatial_sharded runs its bands' host work, in
turns, on one CUDA card.

    python3 bench_sources/spatial_variants.py [--out FILE.json]

The 12 MP portrait (chip_smoke.photo, 3024x4032) and 4000x3008 at
BALANCED's target over 4 bands of cuda:0, and the 12 MP portrait over 2,
each variant's CUDA-event ms per whole call, in turns with the unsharded
search (chip_smoke.unsharded_search):

- shipped: parallel/batched._Shards as it is: a thread per device, so
  the bands of one card run in turn on the calling thread, each on its
  own stream;
- threads: a thread per band (the first design), in a pool made
  per call;
- pool: a thread per band, in one pool kept across calls;
- switch: a thread per band, with the interpreter's switch interval at
  0.1 ms instead of 5 ms.

Every variant's (q, found) and blocks must equal the unsharded search's.
Prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor, wait

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from fennec_tpu_torch.parallel import batched as pb  # noqa: E402
from fennec_tpu_torch.parallel import mesh as pm  # noqa: E402


class Kept:
    """One thread pool per width for every call."""

    pools: dict = {}

    def __init__(self, workers, **kwargs) -> None:
        if workers not in self.pools:
            self.pools[workers] = ThreadPoolExecutor(workers)
        self.submit = self.pools[workers].submit

    def shutdown(self, wait: bool = True) -> None:
        pass


def band_threads(pool_class):
    """A _Shards whose run gives every shard a thread of its own from a
    pool_class(bands) pool."""

    class BandThreads(pb._Shards):
        def __init__(self, devices) -> None:
            super().__init__(devices)
            if self.pool is not None:
                self.pool.shutdown()
            self.pool = pool_class(len(self.devices))

        def run(self, fn, shards=None):
            ks = list(range(len(self.devices))) if shards is None else list(
                shards)
            futures = [self.pool.submit(self._call, fn, k) for k in ks]
            wait(futures)
            return [f.result() for f in futures]

    return BandThreads


def event_ms(fn):
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    got = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), got


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("spatial_variants: no CUDA device")
    smi = cs.nvidia_smi_line()
    print(f"card: {smi}", flush=True)
    one = torch.device("cuda", torch.cuda.current_device())
    shipped = pb._Shards
    real_switch = sys.getswitchinterval()
    variants = {"shipped": (shipped, real_switch),
                "threads": (band_threads(ThreadPoolExecutor), real_switch),
                "pool": (band_threads(Kept), real_switch),
                "switch": (band_threads(ThreadPoolExecutor), 1e-4)}
    results = {}
    for tag, w, h, n in (("12mp_portrait_4", 3024, 4032, 4),
                         ("12mp_landscape_straddling_4", 4000, 3008, 4),
                         ("12mp_portrait_2", 3024, 4032, 2)):
        mesh = pm.data_spatial_mesh(n, n, [one] * n)
        img = torch.from_numpy(cs.photo(w, h, cs.SEED + 1500 + n)).to(one)
        want = cs.unsharded_search(img[None].to(torch.float32), 0.94)
        want_blocks = torch.cat(want[3])
        times = {name: [] for name in ["unsharded", *variants]}

        def run(name):
            if name == "unsharded":
                return event_ms(lambda: cs.unsharded_search(
                    img[None].to(torch.float32), 0.94))[0]
            shards, switch = variants[name]
            pb._Shards = shards
            sys.setswitchinterval(switch)
            try:
                ms, got = event_ms(lambda: pb.quality_search_spatial_sharded(
                    mesh, img, 0.94))
            finally:
                pb._Shards = shipped
                sys.setswitchinterval(real_switch)
            if (int(got[0]), bool(got[2])) != (int(want[0]), bool(want[2])) \
                    or not torch.equal(torch.cat(got[3]), want_blocks):
                raise AssertionError(f"{tag} {name}: differs")
            return ms

        names = list(times)
        for name in names:  # warm-up
            run(name)
        for turn in range(3):
            for name in (names if turn % 2 == 0 else names[::-1]):
                times[name].append(run(name))
        results[tag] = times
        print(f"{tag} over {n} bands (event ms, in turns; {smi}): " +
              ", ".join(f"{k}={[round(t, 3) for t in v]}"
                        for k, v in times.items()), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
