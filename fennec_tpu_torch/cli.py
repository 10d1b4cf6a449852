"""Command-line interface (reference cmd/fennec/main.go); counterpart of
fennec_tpu/cli.py.

Usage: python -m fennec_tpu_torch [options] <input> [output]
       fennec-tpu-torch [options] <input> [output]

--device names the torch device (default cuda; cpu runs the plain
versions of the kernels).  --device-entropy on|off|auto: Huffman-code
JPEGs on the device (kernel K3 on cuda, its plain version on cpu), on
the host C++ encoder, or on the device exactly when it is cuda (the
default); every route writes the same bytes.  -v prints the progress
stages, the result and, to stderr, a `Stages:` report of the wall time of
each pipeline stage (utils/profiling.StageTimer), as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

from . import (
    Context,
    Format,
    Options,
    ProgressStage,
    Quality,
    analyze,
    compress_file,
    open_image,
)
from .utils.profiling import StageTimer, use_timer


def parse_size(s: str) -> int:
    """Parse "100KB" / "2MB" / "51200" (reference cmd/fennec/main.go:16-51)."""
    s = s.strip()
    if not s or s == "0":
        return 0
    upper = s.upper()
    for suffix, mult in (("GB", 1024 ** 3), ("MB", 1024 ** 2),
                         ("KB", 1024), ("B", 1)):
        if upper.endswith(suffix):
            num = s[: len(s) - len(suffix)].strip()
            try:
                return int(float(num) * mult)
            except ValueError:
                raise ValueError(f"invalid size {s!r}")
    try:
        return int(s)
    except ValueError:
        raise ValueError(
            f"invalid size {s!r}: expected number or value like 100KB, 2MB")


def parse_quality(q: str) -> Quality:
    # reference cmd/fennec/main.go:160-175
    return {
        "lossless": Quality.LOSSLESS,
        "ultra": Quality.ULTRA,
        "high": Quality.HIGH,
        "aggressive": Quality.AGGRESSIVE,
        "maximum": Quality.MAXIMUM,
        "max": Quality.MAXIMUM,
    }.get(q.lower(), Quality.BALANCED)


def parse_format(f: str) -> Format:
    # reference cmd/fennec/main.go:177-186
    return {
        "jpeg": Format.JPEG,
        "jpg": Format.JPEG,
        "png": Format.PNG,
    }.get(f.lower(), Format.AUTO)


def default_output(input_path: str) -> str:
    base = input_path
    lower = input_path.lower()
    for ext in (".jpg", ".jpeg", ".png"):
        if lower.endswith(ext):
            base = base[: -len(ext)]
            break
    return base + "_fennec.jpg"


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="fennec-tpu-torch",
        description="SSIM-guided image compression on a CUDA device")
    p.add_argument("--quality", default="balanced", help="Quality preset")
    p.add_argument("--format", default="auto", help="Output format")
    p.add_argument("--max-width", type=int, default=0, help="Max width")
    p.add_argument("--max-height", type=int, default=0, help="Max height")
    p.add_argument("--target-size", default="",
                   help="Target file size (e.g. 100KB, 2MB)")
    p.add_argument("--ssim", type=float, default=0.0,
                   help="Custom SSIM target")
    p.add_argument("--no-orient", action="store_true",
                   help="Don't auto-rotate")
    p.add_argument("--analyze", action="store_true", help="Analyze image")
    p.add_argument("--batch", action="store_true",
                   help="Treat input/output as directories; compress every "
                        "image through the device batch engines")
    p.add_argument("--workers", type=int, default=0,
                   help="Batch worker threads (0 = cpu count)")
    p.add_argument("--skip-existing", action="store_true",
                   help="Batch mode: skip files whose output already exists")
    p.add_argument("--no-optimize-huffman", action="store_true",
                   help="Use fixed Annex-K Huffman tables instead of "
                        "per-image optimal tables (faster, ~3-8% larger)")
    p.add_argument("--device-entropy", choices=("auto", "on", "off"),
                   default="auto",
                   help="Assemble the JPEG bitstream on the device "
                        "(auto: on when --device is cuda)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N, or cpu for the plain "
                        "versions of the kernels)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Verbose output")
    p.add_argument("input", help="Input image path")
    p.add_argument("output", nargs="?", default=None, help="Output path")
    args = p.parse_args(argv)

    if args.analyze:
        return run_analyze(args.input, args.device)
    if args.batch:
        return run_batch(args)
    return run_compression(args)


def run_batch(args) -> int:
    """Directory batch mode (beyond the reference CLI; wraps
    compress_batch and the device batch engines)."""
    import os

    from . import BatchItem, BatchOptions, compress_batch, summarize

    opts = _build_options(args)
    if opts is None:
        return 1
    in_dir, out_dir = args.input, args.output or args.input + "_fennec"
    if not os.path.isdir(in_dir):
        print(f"Error: {in_dir!r} is not a directory", file=sys.stderr)
        return 1
    os.makedirs(out_dir, exist_ok=True)
    exts = (".jpg", ".jpeg", ".png")
    names = sorted(n for n in os.listdir(in_dir)
                   if n.lower().endswith(exts))
    if not names:
        print("Error: no images found", file=sys.stderr)
        return 1
    items = [BatchItem(src=os.path.join(in_dir, n),
                       dst=os.path.join(out_dir, n)) for n in names]

    def on_item(done, total):
        if args.verbose:
            print(f"  [{done}/{total}]", file=sys.stderr)

    start = time.monotonic()
    results = compress_batch(Context.background(), items, BatchOptions(
        workers=args.workers, default_opts=opts, on_item=on_item,
        skip_existing=args.skip_existing), device=args.device)
    elapsed = time.monotonic() - start
    summary = summarize(results)
    for r in results:
        if r.err is not None:
            print(f"  failed: {r.item.src}: {r.err}", file=sys.stderr)
    rate = summary.total / elapsed if elapsed > 0 else 0.0
    print(f"{summary} | {elapsed:.1f}s ({rate:.1f} images/sec)")
    return 0 if summary.failed == 0 else 1


def run_analyze(input_path: str, device: str) -> int:
    # reference cmd/fennec/main.go:100-112
    try:
        img = open_image(input_path, device)
        stats = analyze(img, device)
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Image Analysis: {input_path}")
    print(f"  Dimensions:     {stats.width} x {stats.height}")
    print(f"  Has Alpha:      {str(stats.has_alpha).lower()}")
    print(f"  Grayscale:      {str(stats.is_grayscale).lower()}")
    print(f"  Unique Colors:  {stats.unique_colors}")
    print(f"  Entropy:        {stats.entropy:.2f} bits")
    print(f"  Edge Density:   {stats.edge_density * 100:.2f}%")
    print(f"  Recommended:    {stats.recommended_format} / "
          f"{stats.recommended_quality}")
    return 0


def _build_options(args) -> Optional[Options]:
    """Shared Options construction (reference cmd/fennec/main.go:131-158).
    Returns None (after printing) on invalid flags."""
    opts = Options()
    opts.max_width = args.max_width
    opts.max_height = args.max_height
    if args.no_orient:
        opts.auto_orient = False
    if getattr(args, "no_optimize_huffman", False):
        opts.optimize_huffman = False
    de = getattr(args, "device_entropy", "auto")
    if de != "auto":
        opts.device_entropy = (de == "on")
    if args.ssim > 0:
        if args.ssim > 1.0:
            print("Error: --ssim must be in (0, 1]", file=sys.stderr)
            return None
        opts.target_ssim = args.ssim
    if args.target_size:
        try:
            size = parse_size(args.target_size)
        except ValueError as e:
            print(f"Error: {e}", file=sys.stderr)
            return None
        opts.target_size = size
    opts.quality = parse_quality(args.quality)
    opts.format = parse_format(args.format)
    return opts


def run_compression(args) -> int:
    # reference cmd/fennec/main.go:114-158
    opts = _build_options(args)
    if opts is None:
        return 1
    if args.verbose:
        def on_progress(stage: ProgressStage, pct: float):
            print(f"  [{stage.value}] {pct * 100:.0f}%", file=sys.stderr)
            return None
        opts.on_progress = on_progress

    output = args.output or default_output(args.input)
    timer = StageTimer()
    start = time.monotonic()
    try:
        with use_timer(timer):
            result = compress_file(Context.background(), args.input,
                                   output, opts, device=args.device)
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    elapsed = time.monotonic() - start

    if args.verbose:
        print(f"{result}\n  Time: {elapsed * 1000:.0f}ms")
        report = timer.report()
        if report:
            print(f"  Stages:\n{report}", file=sys.stderr)
    else:
        print(f"{args.input} -> {output} | {result.format} | "
              f"SSIM: {result.ssim:.4f} | "
              f"Saved: {result.savings_percent:.1f}% | "
              f"{elapsed * 1000:.0f}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
