"""generate_preset_samples — render gallery sample images for DB presets.

Counterpart of ``neuralstyletransferv1_tpu/apps/generate_preset_samples.py``,
a port of the reference renderer (reference:
scripts/generate_preset_samples.py): load every preset from presets.db,
pick an input image, render one styled sample per preset at a consistent
resolution (720 long side), skip existing, retry failures, record the
sample path back into the DB. Each preset calls the port's
``engine.pipeline.main`` in process (the reference spawns pipeline.py per
preset, :322-460) on ``--device`` (``cuda`` unless told ``cpu``; no GPU
raises).

    python -m neuralstyletransferv1_torch.apps.generate_preset_samples --db presets.db \
        --input_image in.jpg --limit 2
"""

from __future__ import annotations

import argparse
import pathlib
import random
import re
import sys

from ..presets import connect, load_presets, preset_to_argv, update_sample_path

SAMPLE_SCALE = 720
MAX_RETRIES = 3


def safe_name(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", name).strip("_")[:80]


def collect_input_images(input_dir: pathlib.Path) -> list[pathlib.Path]:
    if not input_dir.exists():
        return []
    return sorted(
        p for p in input_dir.iterdir()
        if p.suffix.lower() in (".jpg", ".jpeg", ".png")
    )


def render_sample(preset: dict, input_image: pathlib.Path, out_dir: pathlib.Path,
                  *, scale: int, work_dir: pathlib.Path, force: bool,
                  device: str = "cuda") -> pathlib.Path | None:
    """One preset → one sample JPEG (reference: :412-460)."""
    from ..engine.pipeline import main as pipeline_main

    out = out_dir / f"{safe_name(preset['name'])}.jpg"
    if out.exists() and not force:
        print(f"  [skip] {preset['name']} (exists)")
        return out
    argv = [
        "--input_image", str(input_image),
        "--output_image", str(out),
        "--work_dir", str(work_dir),
        "--scale", str(scale), "--device", device,
    ] + preset_to_argv(preset["params"])
    try:
        rc = pipeline_main(argv)
    except SystemExit as e:
        rc = e.code or 0
    except Exception as e:
        print(f"  [ERROR] {preset['name']}: {type(e).__name__}: {e}")
        return None
    if rc == 0 and out.exists():
        print(f"  [OK] {preset['name']} -> {out.name}")
        return out
    print(f"  [FAIL] {preset['name']} rc={rc}")
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Render preset gallery samples "
                                 "(reference: scripts/generate_preset_samples.py)")
    ap.add_argument("--db", default="presets.db")
    ap.add_argument("--input_dir", default="input/images")
    ap.add_argument("--input_image", default=None,
                    help="Use one fixed input image for every preset")
    ap.add_argument("--output_dir", default="output/preset_samples")
    ap.add_argument("--work_dir", default="_work/preset_samples")
    ap.add_argument("--scale", type=int, default=SAMPLE_SCALE)
    ap.add_argument("--category", default=None, help="Only this category")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-randomize", action="store_false", dest="randomize")
    ap.add_argument("--max_retries", type=int, default=MAX_RETRIES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    resolve_device(args.device)
    presets = load_presets(args.db)
    if args.category:
        presets = [p for p in presets if (p["category"] or "").lower() == args.category.lower()]
    if args.limit:
        presets = presets[: args.limit]
    if not presets:
        print("[samples] no presets matched")
        return 1

    if args.input_image:
        pool = [pathlib.Path(args.input_image)]
    else:
        pool = collect_input_images(pathlib.Path(args.input_dir))
    if not pool:
        print(f"[samples][error] no input images under {args.input_dir}")
        return 2

    out_dir = pathlib.Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = random.Random(args.seed)

    conn = connect(args.db)
    ok = 0
    for preset in presets:
        img = rng.choice(pool) if args.randomize else pool[0]
        out = None
        for attempt in range(args.max_retries):
            out = render_sample(preset, img, out_dir, scale=args.scale,
                                work_dir=pathlib.Path(args.work_dir), force=args.force,
                                device=args.device)
            if out:
                break
            img = rng.choice(pool)  # retry with another input
        if out:
            update_sample_path(conn, preset["id"], str(out))
            ok += 1
    conn.close()
    print(f"[samples] rendered {ok}/{len(presets)} presets -> {out_dir}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
