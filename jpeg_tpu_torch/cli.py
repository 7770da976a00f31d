"""Command-line interface: ``python -m jpeg_tpu_torch``.

Counterpart of ``jpeg_tpu/cli.py``: the same subcommands (``decode``,
``encode``, ``corpus``, ``info``, ``diff``), options, reports and messages,
and ``--device`` (default ``cuda``) on the commands that decode. A CUDA
device that is not there is an error, not a quiet move to the CPU: pass
``--device cpu`` to run the kernels' plain versions.

Differences from the JAX CLI:

- no persistent compile cache (XLA's); the CUDA kernels are built once into
  ``jpeg_tpu_torch/build/``;
- ``encode`` reads a ``.ppm`` input itself (``io/ppm.py``); other inputs,
  ``--color cmyk|ycck`` and ``diff`` need Pillow, imported inside the
  command, and a missing Pillow is an error naming it;
- ``encode --precision 12`` reads a 16-bit ``.ppm`` (maxval 4095) or
  promotes 8-bit samples (``<< 4``), as the JAX CLI does;
- ``corpus --distributed`` joins a ``torch.distributed`` gloo group
  configured by torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``), where the JAX CLI reads ``JAX_*`` ones.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _device(name: str):
    """``torch.device(name)``; a CUDA device must be present."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device (torch.cuda.is_available() is "
            "False); pass --device cpu to run on the CPU")
    return dev


def cmd_decode(args) -> int:
    from jpeg_tpu_torch.io.container import parse_jpeg
    from jpeg_tpu_torch.io.ppm import write_ppm
    from jpeg_tpu_torch.models.decoder import (
        apply_exif_orientation,
        decode_plan,
        decode_plan_fast,
    )

    dev = _device(args.device)
    with open(args.input, "rb") as f:
        plan = parse_jpeg(f.read())
    if args.path == "fast":
        # As the JAX CLI: the fast path reads neither --engine, --upsample
        # nor --exif-orientation.
        rgb = decode_plan_fast(plan, args.rounding, dev, args.idct)
    else:
        rgb = decode_plan(plan, args.rounding, args.engine,
                          upsample=args.upsample, device=dev)
        if args.exif_orientation:
            rgb = apply_exif_orientation(
                rgb, (plan.exif or {}).get("orientation"))
    write_ppm(args.output, rgb, binary=not args.p3)
    print(f"{args.input}: {rgb.shape[1]}x{rgb.shape[0]} -> {args.output}")
    return 0


def _read_rgb(path: str, precision: int = 8):
    """[H, W, 3] samples of an image file at ``precision``: PPM through
    ``read_ppm``, any other format through Pillow. At 12 bits a PPM is
    maxval 4095 or 8-bit, and 8-bit samples are promoted (``<< 4``), as in
    the JAX CLI."""
    import numpy as np

    if path.lower().endswith(".ppm"):
        from jpeg_tpu_torch.io.ppm import read_ppm

        img, maxval = read_ppm(path, return_maxval=True)
        if precision == 12:
            if img.dtype == np.uint8:
                return img.astype(np.uint16) << 4
            if maxval != 4095:
                # A maxval-65535 PPM would feed samples past the 12-bit
                # level shift and magnitude categories: a corrupt stream.
                raise SystemExit(
                    f"--precision 12 needs a maxval-4095 (or 8-bit) PPM; "
                    f"{path} has maxval {maxval}")
            return img
        if maxval != 255:
            raise SystemExit(f"--precision 8 needs a maxval-255 PPM; {path} "
                             f"has maxval {maxval}")
        return img
    from jpeg_tpu_torch.io.corpus import pil_image

    Image = pil_image(f"encoding {path} (not a .ppm)")
    img = np.asarray(Image.open(path).convert("RGB"))
    return img.astype(np.uint16) << 4 if precision == 12 else img


def cmd_encode(args) -> int:
    import numpy as np

    from jpeg_tpu_torch.models.encoder import (
        encode_cmyk,
        encode_rgb,
        encode_rgb_progressive,
    )

    if args.color in ("cmyk", "ycck"):
        from jpeg_tpu_torch.io.corpus import pil_image

        Image = pil_image(f"--color {args.color}")
        cmyk = np.asarray(Image.open(args.input).convert("CMYK"))
        data = encode_cmyk(cmyk, quality=args.quality,
                           restart_interval_mcus=args.restart_interval,
                           ycck=args.color == "ycck")
        with open(args.output, "wb") as f:
            f.write(data)
        print(f"{args.input} -> {args.output} ({len(data)} bytes)")
        return 0
    img = _read_rgb(args.input, args.precision)
    sub = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}[args.subsampling]
    if args.lossless:
        from jpeg_tpu_torch.entropy.lossless import encode_lossless

        data = encode_lossless(img, predictor=args.predictor,
                               precision=args.precision,
                               restart_interval=args.restart_interval)
        with open(args.output, "wb") as f:
            f.write(data)
        print(f"{args.input} -> {args.output} ({len(data)} bytes, lossless)")
        return 0
    if args.progressive:
        data = encode_rgb_progressive(img, quality=args.quality,
                                      subsampling=sub,
                                      arithmetic=args.arithmetic,
                                      precision=args.precision)
    else:
        data = encode_rgb(img, quality=args.quality, subsampling=sub,
                          restart_interval_mcus=args.restart_interval,
                          optimize=args.optimize, arithmetic=args.arithmetic,
                          precision=args.precision)
    with open(args.output, "wb") as f:
        f.write(data)
    print(f"{args.input} -> {args.output} ({len(data)} bytes)")
    return 0


def cmd_corpus(args) -> int:
    """Decode a corpus directory with resume manifest + JSON metrics."""
    from jpeg_tpu_torch.parallel import distributed

    dev = _device(args.device)
    if args.distributed:
        # Multi-process run: the group supplies this process's shard index
        # (the static --process-index/--count flags are ignored).
        args.process_index, args.process_count = distributed.initialize()
        try:
            return _corpus(args, dev)
        finally:
            distributed.shutdown()
    return _corpus(args, dev)


def _corpus(args, dev) -> int:
    from jpeg_tpu_torch.io.corpus import list_corpus, shard_items
    from jpeg_tpu_torch.models.decoder import decode_file
    from jpeg_tpu_torch.parallel import distributed
    from jpeg_tpu_torch.utils.manifest import Manifest
    from jpeg_tpu_torch.utils.profiling import StageTimer

    paths = list_corpus(args.directory)
    paths = shard_items(paths, args.process_index, args.process_count)
    manifest = Manifest(args.manifest, args.process_index) if args.manifest else None
    if manifest:
        paths = manifest.pending(paths)
    if args.limit:
        # Bounded invocation for process recycling: decode at most N
        # pending images then exit 0; rerunning with the same manifest
        # continues.
        paths = paths[: args.limit]
    timer = StageTimer()
    done = failed = 0
    t0 = time.perf_counter()
    if args.batched:
        from jpeg_tpu_torch.parallel.pipeline import BatchedCorpusDecoder

        # Chunked: the manifest checkpoints after every chunk, so a crash
        # mid-corpus loses at most chunk_size images' work.
        dec = BatchedCorpusDecoder(rounding=args.rounding,
                                   hybrid_device=args.hybrid_device,
                                   idct_mode=args.idct, device=dev)
        chunk = max(1, args.chunk_size)
        try:
            for c0 in range(0, len(paths), chunk):
                part = paths[c0 : c0 + chunk]
                with timer.stage("decode", frames=len(part)):
                    results = dec.decode_all(part)
                for p, r in zip(part, results):
                    if r.ok:
                        done += 1
                        if manifest:
                            manifest.mark_done(p, h=int(r.rgb.shape[0]),
                                               w=int(r.rgb.shape[1]))
                    else:
                        failed += 1
                        print(f"FAILED {p}: {r.error}", file=sys.stderr)
        finally:
            dec.close()
    else:
        for p in paths:
            try:
                with timer.stage("decode", frames=1):
                    rgb = decode_file(p, rounding=args.rounding,
                                      engine=args.engine, device=dev)
                done += 1
                if manifest:
                    manifest.mark_done(p, h=int(rgb.shape[0]),
                                       w=int(rgb.shape[1]))
            except Exception as e:  # per-image error isolation (SURVEY.md §5)
                # A build, launch or CUDA error is not the image's fault.
                if isinstance(e, RuntimeError):
                    raise
                failed += 1
                print(f"FAILED {p}: {e}", file=sys.stderr)
    if manifest:
        manifest.close()
    wall = time.perf_counter() - t0
    report = {
        "decoded": done,
        "failed": failed,
        "wall_s": round(wall, 3),
        "frames_per_s": round(done / wall, 2) if wall > 0 else None,
        "process_index": args.process_index,
        "stages": timer.report(),
    }
    if args.distributed:
        # Totals across processes: every process reports the same aggregate
        # block (sum of frames and of per-process rates) beside its own.
        report["aggregate"] = distributed.aggregate_metrics({
            "decoded": float(done),
            "failed": float(failed),
            "frames_per_s": done / wall if wall > 0 else 0.0,
        })
        report["process_count"] = args.process_count
    print(json.dumps(report))
    return 1 if failed and args.strict else 0


def cmd_info(args) -> int:
    """Print stream metadata as JSON (the reference left this as a TODO,
    src/jpeg/mod.rs:350-352: "might be useful if we want to print info")."""
    from jpeg_tpu_torch.io.container import parse_jpeg

    with open(args.input, "rb") as f:
        plan = parse_jpeg(f.read())
    print(json.dumps({
        "width": plan.width,
        "height": plan.height,
        "components": [
            {"id": c.component_id, "sampling": [c.h, c.v],
             "quant_table": c.quant_id, "dc_table": c.dc_id,
             "ac_table": c.ac_id}
            for c in plan.components
        ],
        "color_model": plan.color_model,
        "progressive": plan.progressive,
        "arithmetic": plan.arith_code,
        "precision": plan.precision,
        "lossless": plan.lossless,
        "predictor": plan.predictor or None,
        "point_transform": plan.point_transform or None,
        "mcus": [plan.mcus_x, plan.mcus_y],
        "restart_interval_mcus": plan.restart_interval,
        "entropy_segments": len(plan.segments),
        "entropy_bytes": int(plan.scan_data.size),
        "jfif_version": plan.jfif_version,
        "jfif_density": plan.jfif_density,
        "comment": plan.comment,
        "exif": plan.exif,
    }))
    return 0


def cmd_diff(args) -> int:
    """Decode + compare against PIL/libjpeg; print PSNR (Makefile:4-7 role)."""
    import numpy as np

    from jpeg_tpu_torch.io.container import parse_jpeg
    from jpeg_tpu_torch.io.corpus import pil_image
    from jpeg_tpu_torch.models.decoder import decode_plan

    Image = pil_image("diff (libjpeg through Pillow)")
    dev = _device(args.device)
    with open(args.input, "rb") as f:
        ours = decode_plan(parse_jpeg(f.read()), rounding=args.rounding,
                           upsample=args.upsample, device=dev)
    pil = np.asarray(Image.open(args.input).convert("RGB"))
    mse = ((ours.astype(np.float64) - pil.astype(np.float64)) ** 2).mean()
    psnr = float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)
    print(json.dumps({
        "input": args.input,
        "shape": list(ours.shape),
        "psnr_vs_libjpeg_db": round(psnr, 2),
        "max_abs_diff": int(np.abs(ours.astype(int) - pil.astype(int)).max()),
    }))
    if args.diff_output:
        diff = np.abs(ours.astype(int) - pil.astype(int))
        amplified = np.clip(diff * args.amplify, 0, 255).astype(np.uint8)
        Image.fromarray(amplified).save(args.diff_output)
    return 0


def _add_device(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (cuda, cuda:N or cpu); "
                        "cpu runs the kernels' plain versions")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="jpeg_tpu_torch",
        description="JPEG engine on PyTorch and CUDA (Hopper)")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("decode", help="decode JPEG to PPM (reference CLI parity)")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument("--rounding", choices=["truncate", "round"], default="truncate")
    d.add_argument("--engine", choices=["auto", "native", "oracle"], default="auto")
    d.add_argument("--idct", choices=["exact", "approx"], default="exact",
                   help="approx = K1a on the fast path: the IDCT's operands "
                        "rounded to bf16 as the TPU's DEFAULT precision "
                        "rounds them (gate: max |diff| <= 2 u8 / PSNR >= 50 "
                        "dB vs exact, docs/APPROX_QUALITY.md; measured on "
                        "the H100 by python -m "
                        "jpeg_tpu_torch.tools.measure_approx_quality, table "
                        "in PERF.md)")
    d.add_argument("--path", choices=["compat", "fast"], default="compat",
                   help="fast = plane-layout pipeline (the K1 kernel)")
    d.add_argument("--upsample", choices=["replicate", "fancy"],
                   default="replicate",
                   help="fancy = libjpeg-style triangular chroma filter")
    d.add_argument("--exif-orientation", action="store_true",
                   help="apply the EXIF orientation tag")
    d.add_argument("--p3", action="store_true",
                   help="ASCII P3 output (reference main.rs format); default P6")
    _add_device(d)
    d.set_defaults(fn=cmd_decode)

    e = sub.add_parser("encode", help="encode image to baseline JPEG")
    e.add_argument("input")
    e.add_argument("output")
    e.add_argument("--quality", type=int, default=85)
    e.add_argument("--subsampling", choices=["444", "422", "420"], default="420")
    e.add_argument("--restart-interval", type=int, default=0,
                   help="MCUs per restart segment (0 = none)")
    e.add_argument("--optimize", action="store_true",
                   help="per-image optimal Huffman tables (Annex K.2)")
    e.add_argument("--precision", type=int, choices=[8, 12], default=8,
                   help="sample precision (12 = SOF1/SOF9 extended; input "
                        "is a 16-bit .ppm or promoted 8-bit)")
    e.add_argument("--arithmetic", action="store_true",
                   help="QM arithmetic entropy coding (SOF9/SOF10)")
    e.add_argument("--lossless", action="store_true",
                   help="SOF3 lossless (T.81 Annex H)")
    e.add_argument("--predictor", type=int, choices=range(1, 8), default=1,
                   help="lossless predictor selection (T.81 H.1.2.1)")
    e.add_argument("--progressive", action="store_true",
                   help="progressive (SOF2) output")
    e.add_argument("--color", choices=["auto", "cmyk", "ycck"], default="auto",
                   help="cmyk/ycck = 4-component Adobe APP14 output")
    e.set_defaults(fn=cmd_encode)

    c = sub.add_parser("corpus", help="decode a corpus directory (resumable)")
    c.add_argument("directory")
    c.add_argument("--manifest", default=None, help="resume manifest path stem")
    c.add_argument("--rounding", choices=["truncate", "round"], default="truncate")
    c.add_argument("--engine", choices=["auto", "native", "oracle"], default="auto")
    c.add_argument("--process-index", type=int, default=0)
    c.add_argument("--process-count", type=int, default=1)
    c.add_argument("--strict", action="store_true", help="exit 1 on any failure")
    c.add_argument("--idct", choices=["exact", "approx"], default="exact",
                   help="approx IDCT tier for the batched pixel kernel (K1a; "
                        "quality-gated, docs/APPROX_QUALITY.md; the H100's "
                        "measurement of the gate is in PERF.md, by python -m "
                        "jpeg_tpu_torch.tools.measure_approx_quality)")
    c.add_argument("--hybrid-device", action="store_true",
                   help="with --batched: the card also entropy-decodes "
                        "batches of images (the K3 kernel) beside the host "
                        "workers")
    c.add_argument("--limit", type=int, default=0,
                   help="decode at most N pending images this invocation "
                        "then exit (process recycling; combine with "
                        "--manifest)")
    c.add_argument("--chunk-size", type=int, default=64,
                   help="batched mode: images per decode_all chunk; the "
                        "manifest checkpoints after every chunk (crash "
                        "loses at most one chunk)")
    c.add_argument("--batched", action="store_true",
                   help="geometry-bucketed batch decode (the fast path)")
    c.add_argument("--distributed", action="store_true",
                   help="multi-process mode: join the torch.distributed "
                        "gloo group that torchrun's MASTER_ADDR, MASTER_PORT, "
                        "WORLD_SIZE and RANK describe, decode this process's "
                        "shard and report totals across processes")
    _add_device(c)
    c.set_defaults(fn=cmd_corpus)

    i = sub.add_parser("info", help="print stream metadata as JSON")
    i.add_argument("input")
    i.set_defaults(fn=cmd_info)

    f = sub.add_parser("diff", help="PSNR vs libjpeg (visual-diff harness)")
    f.add_argument("input")
    f.add_argument("--rounding", choices=["truncate", "round"], default="round")
    f.add_argument("--upsample", choices=["replicate", "fancy"],
                   default="replicate")
    f.add_argument("--diff-output", default=None)
    f.add_argument("--amplify", type=int, default=16)
    _add_device(f)
    f.set_defaults(fn=cmd_diff)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
