"""Time chip_smoke.py's 512-file 500x500 compress_batch (phase 6) for two
checkouts of the port in turns, on one CUDA card.

    python3 bench_sources/batch_ab.py CHECKOUT_A CHECKOUT_B [--rounds N]

Each turn is a process of its own that imports fennec_tpu_torch from its
checkout, builds that checkout's kernels at first use, writes the 512
files (chip_smoke.write_files500, numpy seeds) and runs compress_batch
once cold and `--rounds` times warm (default 3), printing each warm
pass's wall ms and img/s and the engine's host seconds per stage.  The
turns go A, B, B, A, so that a drift of the host shows on both sides.
Prints the card's name and power limit first and a digest of the
outputs of every turn (the two checkouts must agree).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_turn(checkout: str, rounds: int) -> None:
    sys.path.insert(0, os.path.abspath(checkout))
    sys.path.insert(1, HERE)
    import torch

    import chip_smoke as cs
    import fennec_tpu_torch as T
    from fennec_tpu_torch.engine.batched import counters

    if not torch.cuda.is_available():
        raise SystemExit("batch_ab: no CUDA device")
    if not T.__file__.startswith(os.path.abspath(checkout)):
        raise SystemExit(f"batch_ab: imported {T.__file__}")
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        paths, _ = cs.write_files500(T, dev, os.path.join(tmp, "in"))
        opts = T.BatchOptions(fused=True,
                              default_opts=T.Options(format=T.JPEG))
        outs = None
        for k in range(rounds + 1):
            items = [T.BatchItem(src=p, dst=os.path.join(tmp, f"o{i}.jpg"))
                     for i, p in enumerate(paths)]
            counters.reset()
            t = time.perf_counter()
            res = T.compress_batch(None, items, opts, device=dev)
            wall = time.perf_counter() - t
            if any(r.err is not None for r in res):
                raise SystemExit("batch_ab: an item failed")
            outs = [r.result.compressed_data for r in res]
            st = counters.snapshot()["stage_seconds"]
            print(f"batch512 {checkout} {'warm' if k else 'cold'} "
                  f"wall_ms={wall * 1e3:.1f} img_per_s={len(paths) / wall:.1f}"
                  f" prep_s={st.get('prep', 0):.3f} device_s="
                  f"{st.get('device', 0):.3f} encode_summed_s="
                  f"{st.get('encode', 0):.3f}", flush=True)
        print(f"batch512 {checkout} digest={cs.digest(outs)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--one", action="store_true",
                    help="run one turn for the single checkout given")
    args = ap.parse_args()
    if args.one:
        one_turn(args.checkouts[0], args.rounds)
        return 0
    if len(args.checkouts) != 2:
        raise SystemExit("batch_ab: give two checkouts")
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    print(f"card: {cs.nvidia_smi_line()}", flush=True)
    a, b = args.checkouts
    for checkout in (a, b, b, a):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        "--rounds", str(args.rounds), checkout], check=True,
                       timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
